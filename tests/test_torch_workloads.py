"""K-Means and Givens QR on the port against the reference, same inputs.

Inputs are made with numpy from a seed and handed to both packages. The
port and the reference sum the einsums in different orders (torch's CPU
matmul vs XLA's), so distances and centroid sums can differ in the last
bits: K-Means is held to >= 99.9% assignment agreement and 1e-5 relative
inertia, QR to the reference's residual gate (5e-6) and 1e-5 on Q and R.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import division_modes as ref_dm
from repro.workloads import kmeans as ref_kmeans
from repro.workloads import qr as ref_qr
from repro_torch import convert
from repro_torch.core import division_modes as dm
from repro_torch.eval import workload_metrics as wm
from repro_torch.workloads import kmeans, qr
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

KM_MODES = ["exact", "taylor", "taylor_pallas", "goldschmidt_pallas"]


def _blobs(n=2048, d=16, k=8, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, (k, d))
    x = centers[rng.integers(0, k, n)] + 0.15 * rng.standard_normal((n, d))
    x = x.astype(np.float32)
    return x, x[rng.choice(n, k, replace=False)]


@pytest.mark.parametrize("mode", KM_MODES)
def test_kmeans_matches_reference(mode):
    x, init = _blobs()
    ref = ref_kmeans.kmeans(jnp.asarray(x), cfg=ref_dm.DivisionConfig(mode=mode),
                            init=jnp.asarray(init))
    t = convert.tensors_from_numpy({"x": x, "init": init}, "cpu")
    got = kmeans.kmeans(t["x"], cfg=dm.DivisionConfig(mode=mode), init=t["init"],
                        device="cpu")
    agree = (got.assignments.numpy() == np.asarray(ref.assignments)).mean()
    assert agree >= 0.999
    assert wm.relative_delta(got.inertia.numpy(), np.asarray(ref.inertia)) <= 1e-5
    assert got.inertia_trace.shape == (10,)
    assert wm.relative_delta(got.inertia_trace.numpy(),
                             np.asarray(ref.inertia_trace)) <= 1e-5


def test_kmeans_modes_agree_with_exact_twin():
    x, init = _blobs(seed=1)
    runs = {m: kmeans.kmeans(torch.from_numpy(x), cfg=dm.DivisionConfig(mode=m),
                             init=torch.from_numpy(init), device="cpu")
            for m in ("exact", "taylor_pallas", "goldschmidt_pallas")}
    for m in ("taylor_pallas", "goldschmidt_pallas"):
        assert wm.relative_delta(runs[m].inertia.numpy(),
                                 runs["exact"].inertia.numpy()) <= 1e-4
        assert (runs[m].assignments == runs["exact"].assignments).float().mean() >= 0.99


def test_kmeans_empty_cluster_keeps_its_centroid():
    x = torch.tensor([[0.0, 0.0], [0.1, 0.0], [1.0, 1.0], [1.1, 1.0]])
    init = torch.tensor([[0.0, 0.0], [1.0, 1.0], [50.0, 50.0]])
    res = kmeans.kmeans(x, init=init, n_iters=2, device="cpu",
                        cfg=dm.DivisionConfig(mode="taylor_pallas"))
    assert torch.equal(res.centroids[2], init[2])
    assert res.assignments.tolist() == [0, 0, 1, 1]


def test_kmeans_batched_and_default_init():
    x, _ = _blobs(n=256, d=4, k=3)
    xb = torch.from_numpy(np.stack([x, x[::-1].copy()]))
    res = kmeans.kmeans(xb, 3, n_iters=3, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    assert res.centroids.shape == (2, 3, 4) and res.assignments.shape == (2, 256)
    assert res.inertia_trace.shape == (3, 2)
    again = kmeans.kmeans(xb, 3, n_iters=3, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    assert torch.equal(res.centroids, again.centroids)
    with pytest.raises(ValueError):
        kmeans.kmeans(xb, device="cpu")


def test_make_blobs_is_seeded():
    a = kmeans.make_blobs(torch.Generator().manual_seed(7), 100, 5, 4)
    b = kmeans.make_blobs(torch.Generator().manual_seed(7), 100, 5, 4)
    assert a.shape == (100, 5) and a.dtype == torch.float32
    assert torch.equal(a, b)


@pytest.mark.parametrize("via", ["div", "rsqrt"])
@pytest.mark.parametrize("mode", ["exact", "taylor_pallas"])
def test_qr_matches_reference(mode, via):
    a = np.random.default_rng(4).standard_normal((24, 16)).astype(np.float32)
    rq, rr = ref_qr.qr_givens(jnp.asarray(a), ref_dm.DivisionConfig(mode=mode), via=via)
    q, r = qr.qr_givens(torch.from_numpy(a), dm.DivisionConfig(mode=mode), via=via,
                        device="cpu")
    assert q.shape == (24, 24) and r.shape == (24, 16)
    np.testing.assert_allclose(q.numpy(), np.asarray(rq), rtol=0, atol=1e-5)
    np.testing.assert_allclose(r.numpy(), np.asarray(rr), rtol=0, atol=1e-5)
    res = wm.qr_residuals(q.numpy(), r.numpy(), a)
    assert res["orthogonality"] <= 5e-6 and res["reconstruction"] <= 5e-6
    assert res["triangularity"] <= 5e-6


def test_qr_batched_equals_per_matrix_and_reference():
    a = np.random.default_rng(5).standard_normal((2, 3, 6, 4)).astype(np.float32)
    cfg = dm.DivisionConfig(mode="goldschmidt_pallas")
    q, r = qr.qr_givens_batched(torch.from_numpy(a), cfg, via="rsqrt", device="cpu")
    assert q.shape == (2, 3, 6, 6) and r.shape == (2, 3, 6, 4)
    q1, r1 = qr.qr_givens(torch.from_numpy(a[1, 2]), cfg, via="rsqrt", device="cpu")
    assert torch.equal(q[1, 2], q1) and torch.equal(r[1, 2], r1)
    rq, rr = ref_qr.qr_givens_batched(jnp.asarray(a),
                                      ref_dm.DivisionConfig(mode="goldschmidt_pallas"),
                                      via="rsqrt")
    np.testing.assert_allclose(q.numpy(), np.asarray(rq), rtol=0, atol=1e-5)
    np.testing.assert_allclose(r.numpy(), np.asarray(rr), rtol=0, atol=1e-5)


def test_givens_coeffs_identity_corner_and_bad_via():
    z = torch.zeros(3)
    c, s = qr.givens_coeffs(z, z, dm.DivisionConfig(mode="taylor_pallas"))
    assert c.tolist() == [1.0] * 3 and s.tolist() == [0.0] * 3
    with pytest.raises(ValueError):
        qr.givens_coeffs(z, z, via="sqrt")
    with pytest.raises(ValueError):
        qr.qr_givens(torch.zeros(2, 2, 2), device="cpu")


def test_make_blobs_stays_on_the_generators_device():
    import inspect

    assert inspect.signature(kmeans.make_blobs).parameters["device"].default is None
    x = kmeans.make_blobs(torch.Generator(device="cpu").manual_seed(1), 10, 3, 2)
    assert x.device.type == "cpu" and x.shape == (10, 3)
    y = kmeans.make_blobs(torch.Generator().manual_seed(1), 10, 3, 2, device="cpu")
    assert torch.equal(x, y)
