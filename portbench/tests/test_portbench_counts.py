"""The frozen counts against hand computations at one shape each."""
import json
from pathlib import Path

import pytest
import torch

from portbench.counts import flops, rmsnorm_f32, softmax_f32

ROOT = Path(__file__).resolve().parents[2]


def _sizes(name):
    return json.loads((ROOT / f"portbench/configs/{name}.json").read_text())["port"]


def test_deepseek_active_multiply_adds_a_token():
    attn = 4 * 2048 * 2048                                    # q, k, v, o
    dense = 3 * 2048 * 10944                                  # layer 0
    moe = 2048 * 64 + 6 * 3 * 2048 * 1408 + 3 * 2048 * 2816   # router, 6 routed, shared
    assert attn * 28 + dense + moe * 27 == 2_409_103_360
    assert flops.active_macs(_sizes("dsmoe16b")) == 2_409_103_360


def test_mamba2_active_multiply_adds_a_token():
    per = 1536 * (2 * 3072 + 2 * 128 + 48) + 3072 * 1536 + 4 * (3072 + 256)
    assert flops.active_macs(_sizes("mamba2")) == 48 * per


def test_request_flops_by_hand():
    s = _sizes("dsmoe16b")
    # A prompt of 3 tokens, 2 served (1 fed back): 4 tokens read, keys 1+2+3+4.
    want = (2.0 * 2_409_103_360 * 4 + 2.0 * 2048 * 102400 * 2
            + 28 * 4.0 * 16 * 128 * 10)
    assert flops.request_flops(s, 3, 2) == pytest.approx(want, rel=1e-12)
    m = _sizes("mamba2")
    scan = 48 * ((2.0 * 256 * 128 + 2.0 * 256 * 3072 + 4.0 * 3072 * 128) * 3
                 + 4.0 * 3072 * 128 * 1)
    want = 2.0 * flops.active_macs(m) * 4 + 2.0 * 1536 * 50280 * 2 + scan
    assert flops.request_flops(m, 3, 2) == pytest.approx(want, rel=1e-12)


def test_kernel_bytes_by_hand():
    x = torch.empty(1000, 2048, dtype=torch.bfloat16)
    w = torch.empty(2048, dtype=torch.float32)
    assert rmsnorm_f32.call_bytes((x, w)) == 2 * 1000 * 2048 * 2 + 2048 * 4
    s = torch.empty(256, 4096, dtype=torch.float32)
    assert softmax_f32.call_bytes((s,)) == 2 * 256 * 4096 * 4
