"""The frozen cost arithmetic against counts worked out by hand for the two
cells' shapes: phi3-mini's training step (2 x 4096 tokens, 32 MHA heads of
96) and mixtral's prefill (8 prompts, 32 / 8 heads of 128, 8 experts top-2)."""
import json
from pathlib import Path

import pytest

from portbench import cost

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
PHI3 = json.loads((CONFIGS / "phi3-mini-3.8b.json").read_text())
MIXTRAL = json.loads((CONFIGS / "mixtral-8x7b.json").read_text())


@pytest.mark.parametrize("args, pairs", [
    ((4096, 4096), 4096 * 4097 // 2),          # causal: 1 + 2 + ... + 4096
    ((6, 6, True, 2), 1 + 2 + 2 + 2 + 2 + 2),  # a window of 2 keys
    ((4, 6, False), 4 * 6),                    # every pair
    ((8, 8, True, 0, 4), 2 * (1 + 2 + 3 + 4)),  # two causal chunks of 4
    ((512, 512, True, 4096), 512 * 513 // 2),  # mixtral's window masks nothing here
])
def test_visible_pairs_by_hand(args, pairs):
    assert cost.visible_pairs(*args) == pairs


def test_phi3_attention_backward_by_hand():
    # one microbatch: q, k, v, out, dout, dq, dk, dv of 4096 x 32 x 96 bf16,
    # the float32 logsumexp of 32 x 4096 rows
    n = 4096 * 32 * 96
    flops, nbytes = cost.attention_cost(1, 4096, 4096, 32, 32, 96, itemsize=2, backward=True)
    assert flops == 10 * 32 * 96 * 8_390_656 == 257_760_952_320
    assert nbytes == 2 * 8 * n + 4 * 32 * 4096 == 201_850_880


def test_phi3_attention_forward_by_hand():
    n = 4096 * 32 * 96
    flops, nbytes = cost.attention_cost(1, 4096, 4096, 32, 32, 96, itemsize=2, lse=True)
    assert flops == 4 * 32 * 96 * 8_390_656 == 103_104_380_928
    assert nbytes == 2 * 4 * n + 4 * 32 * 4096 == 101_187_584


def test_mixtral_prefill_attention_by_hand():
    # 8 prompts of 512: q and out 8 x 512 x 32 x 128, k and v 8 x 512 x 8 x 128
    flops, nbytes = cost.attention_cost(8, 512, 512, 32, 8, 128, itemsize=2,
                                        window=4096)
    assert flops == 4 * 8 * 32 * 128 * 131_328 == 17_213_423_616
    assert nbytes == 2 * (2 * 8 * 512 * 32 * 128 + 2 * 8 * 512 * 8 * 128) == 83_886_080
    # 83.9 MB at 3.35 TB/s outlasts 17.2 GFLOP at 989 TFLOP/s: bound by bytes
    assert cost.bound_seconds(flops, nbytes) == pytest.approx(83_886_080 / 3.35e12)


def test_phi3_train_model_flops_by_hand():
    # a layer: q, k, v, o of 3072 x 3072 and w1, w3, w2 of 3072 x 8192
    layer = 4 * 3072 * 3072 + 3 * 3072 * 8192
    assert layer == 113_246_208
    n = 32 * layer + 3072 * 32_064  # and the untied head
    attention = 12 * 96 * 32 * 32 * 8_390_656 * 2  # 32 layers, 2 sequences
    assert cost.train_model_flops(PHI3, 2, 4096) == 6 * n * 8192 + attention


def test_mixtral_prefill_model_flops_by_hand():
    # a layer: q and o 4096 x 4096, k and v 4096 x 1024, the router 4096 x 8
    # and 2 of 8 experts of three 4096 x 14336 matrices
    layer = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 4096 * 8 + 2 * 3 * 4096 * 14336
    assert layer == 394_297_344
    assert cost.layer_matmul_params(MIXTRAL, 0) == layer
    want = (2 * 16 * layer * 8 * 512 + 2 * 4096 * 32_000 * 8
            + 4 * 128 * 32 * 16 * 131_328 * 8)
    assert cost.prefill_model_flops(MIXTRAL, 8, 512) == want
