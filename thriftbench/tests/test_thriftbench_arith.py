"""The operation and byte counts agree with a hand count."""
import itertools
import math

import pytest

from thriftbench.metrics import arith
from thriftbench.tests import tiny
from thriftbench.weights import derived, layer_spec

STARCODER2 = {"num_layers": 32, "d_model": 4608, "num_heads": 36, "num_kv_heads": 4,
              "head_dim": 128, "d_ff": 18432, "vocab_size": 49152, "window": 0,
              "block_pattern": ["attn"], "mlp_variant": "gelu"}
DANUBE = dict(STARCODER2, d_model=2560, num_heads=32, num_kv_heads=8, head_dim=80, window=3)
MAMBA = {"num_layers": 1, "d_model": 4, "ssm_state": 2, "ssm_expand": 2, "ssm_conv": 4,
         "ssm_dt_rank": 1, "vocab_size": 8, "block_pattern": ["ssm"]}


def pairs_by_hand(S, window):
    return sum(1 for q, k in itertools.product(range(S), repeat=2)
               if k <= q and (window <= 0 or q - k < window))


@pytest.mark.parametrize("model,S", [(STARCODER2, 4), (DANUBE, 6)])
def test_flash_launch_by_hand(model, S):
    B, H, G, hd = 2, model["num_heads"], model["num_kv_heads"], model["head_dim"]
    pairs = pairs_by_hand(S, model["window"])
    got = arith.flash_launch(model, B, S)
    assert got["ops"] == 4 * hd * pairs * B * H          # QK^T and PV, 2 ops a multiply-add
    q_o = 2 * B * S * H * hd                             # q read, o written
    k_v = 2 * B * S * G * hd                             # k and v read
    assert got["bytes"] == 2 * (q_o + k_v)               # bf16
    assert got["bound_s"] == max(got["ops"] / 989e12, got["bytes"] / 3.35e12)


def test_visible_pairs_at_route_shape():
    assert arith.visible_pairs(127, 0) == 127 * 128 // 2
    assert arith.visible_pairs(127, 4096) == 127 * 128 // 2
    assert arith.visible_pairs(10, 3) == pairs_by_hand(10, 3)


def test_mamba_launch_by_hand():
    B, S, Din, N = 2, 3, 8, 2
    got = arith.mamba_launch(MAMBA, B, S)
    assert got["ops"] == B * S * Din * N * 7 + B * S * Din * 3
    x_y = 2 * (B * S * Din) * 2             # x read, y written, bf16
    bc = 2 * (B * S * N) * 2                # B and C read, bf16
    dt = 4 * B * S * Din                    # f32
    a_d = 4 * (Din * N + Din)               # A and D, f32
    h = 4 * B * Din * N                     # last state written, f32
    assert got["bytes"] == x_y + bc + dt + a_d + h
    assert got["term"] == "bytes"


def test_mamba_bound_at_the_route_shape():
    falcon = {"num_layers": 64, "d_model": 4096, "ssm_state": 16, "ssm_expand": 2,
              "ssm_conv": 4, "vocab_size": 65024, "block_pattern": ["ssm"]}
    got = arith.mamba_launch(falcon, 64, 127)
    assert got["term"] == "bytes"
    assert 0.15e-3 < got["bound_s"] < 0.18e-3


@pytest.mark.parametrize("B,S,D", [(128, 127, 4096), (2, 3, 4)])
def test_causal_conv1d_bound_by_hand(B, S, D):
    """The x half read once and y written once (bf16), the taps (bf16) and
    the bias (f32) once: at falcon-mamba-7b's route shape, 0.159 ms."""
    model = dict(MAMBA, d_model=D)
    Din, K = 2 * D, 4
    got = arith.load_kernel("causal_conv1d").bound(derived(model), "ssm", B, S)
    x_y = 2 * (B * S * Din) * 2
    w_b = 2 * Din * K + 4 * Din
    assert got["bytes"] == x_y + w_b
    assert got["ops"] == B * S * Din * (2 * K + 1)
    assert got["term"] == "bytes"
    assert got["bound_s"] == got["bytes"] / 3.35e12
    if B == 128:
        assert x_y + w_b == 532_774_912
        assert 0.1590e-3 < got["bound_s"] < 0.1591e-3


@pytest.mark.parametrize("arch", sorted(tiny.ARMS))
def test_forward_flops_by_hand(arch):
    model = tiny.ARMS[arch]
    m = derived(model)
    S = 7
    total = 0
    for btype in m["layer_types"]:
        for name, shape, kind, _ in layer_spec(m, btype):
            if kind != "mat" or name in ("conv_w",):
                continue
            if name in ("ewg", "ewu", "ewd"):       # a token meets k of the E experts
                total += 2 * S * m["experts_per_token"] * math.prod(shape[1:])
            else:
                total += 2 * S * math.prod(shape)
        if btype in ("attn", "moe"):
            total += 4 * m["num_heads"] * m["head_dim"] * pairs_by_hand(S, m.get("window", 0))
        else:
            total += S * (2 * m["ssm_conv"] * m["d_inner"]
                          + 7 * m["d_inner"] * m["ssm_state"] + 3 * m["d_inner"])
    total += 2 * m["d_model"] * m["vocab_size"]         # the head at the answer position only
    assert arith.forward_flops(model, S) == total
