"""The port's data pipeline against the reference's: the same batches, bit
for bit, over steps, seeds and host shardings, and the prefetch iterator."""
import numpy as np
import pytest

from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro_torch.data import DataConfig, SyntheticLM
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CONFIGS = [dict(vocab=1000, seq_len=64, global_batch=8, seed=7),
           dict(vocab=256, seq_len=33, global_batch=4, seed=1, motif_frac=0.25),
           dict(vocab=32_000, seq_len=128, global_batch=4, seed=0, zipf_a=1.1)]


@pytest.mark.parametrize("fields", CONFIGS)
@pytest.mark.parametrize("hosts", [1, 4])
def test_batches_are_the_references_bit_for_bit(fields, hosts):
    for host in range(hosts):
        mine = SyntheticLM(DataConfig(**fields), host_index=host, host_count=hosts)
        theirs = RefSyntheticLM(RefDataConfig(**fields), host_index=host, host_count=hosts)
        for step in (0, 5, 1000):
            got, want = mine.batch(step), theirs.batch(step)
            assert set(got) == set(want) == {"tokens", "labels"}
            for k in got:
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])
            assert got["tokens"].shape == (fields["global_batch"] // hosts, fields["seq_len"])
            np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def test_prefetch_iterator_gives_the_references_batches():
    fields = dict(vocab=200, seq_len=16, global_batch=2)
    it = SyntheticLM(DataConfig(**fields)).iter(start_step=3)
    theirs = RefSyntheticLM(RefDataConfig(**fields))
    for step in (3, 4, 5):
        got = next(it)
        np.testing.assert_array_equal(got["tokens"], theirs.batch(step)["tokens"])
        np.testing.assert_array_equal(got["labels"], theirs.batch(step)["labels"])
    it.close()


def test_uneven_host_split_raises():
    with pytest.raises(ValueError, match="does not split"):
        SyntheticLM(DataConfig(vocab=10, seq_len=4, global_batch=6), host_count=4)
