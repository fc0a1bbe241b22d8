"""portbench/counts.py against FLOPs and bytes worked by hand."""

import pytest

from portbench import counts


def test_attention_work_small_shape_by_hand():
    # B1 S4 H2 KV1 dh8, causal: query q sees q + 1 keys, 1 + 2 + 3 + 4 = 10 pairs
    nbytes, flops = counts.attention_work(1, 4, 4, 2, 1, 8, True, None, 2)
    assert flops == 4 * 8 * 10 * 2
    assert nbytes == 2 * 8 * (2 * 4 * 2 + 2 * 4 * 1)
    # a window of 2 keys: 1 + 2 + 2 + 2 = 7 pairs
    assert counts.attention_work(1, 4, 4, 2, 1, 8, True, 2, 2)[1] == 4 * 8 * 7 * 2


@pytest.mark.parametrize("S,window", [(1, None), (7, None), (4096, None), (8192, 4096),
                                      (5, 8), (100, 1), (4097, 4096)])
def test_causal_pairs_matches_the_frozen_loop(S, window):
    flops = counts.attention_work(1, S, S, 1, 1, 1, True, window, 2)[1]
    assert counts.causal_pairs(S, window) * 4 == flops


def test_one_model_step_by_hand():
    cfg = {"d_model": 8, "n_heads": 2, "n_kv_heads": 1, "head_dim": 4, "d_ff": 6,
           "vocab_size": 10, "n_layers": 3, "swa_window": None,
           "moe": {"n_experts": 4, "top_k": 2}}
    # q 8x8, k 8x4, v 8x4, o 8x8 = 192; router 8x4 = 32; 2 experts of 3 x 8 x 6 = 288
    assert counts.layer_weights(cfg) == 192 + 32 + 288
    pairs = 5 * 6 // 2                          # S = 5, causal
    attn = 3 * 4 * 4 * 2 * 2 * pairs            # layers x 4 dh x H x B x pairs
    assert counts.attention_flops(cfg, 2, 5) == attn
    assert counts.prefill_flops(cfg, 2, 5) == 2 * 3 * 512 * 2 * 5 + 2 * 8 * 10 * 2 + attn
    assert counts.train_flops(cfg, 2, 5) == 6 * (3 * 512 + 80) * 2 * 5 + 3 * attn
    dense = dict(cfg, moe=None)
    assert counts.layer_weights(dense) == 192 + 3 * 8 * 6


def test_bound_takes_the_larger_term():
    assert counts.bound_s(counts.PEAK_BF16_FLOPS, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, counts.PEAK_HBM_BYTES_S * 2) == pytest.approx(2.0)
