"""The frozen arithmetic: hand counts, and the program's own copy at two
shapes."""
import pytest

from portbench.harness import roofline, spec
from repro_torch.roofline import analysis


def test_flash_and_decode_and_scan_by_hand():
    # causal 4 x 4: 1 + 2 + 3 + 4 = 10 pairs; window 2: 1 + 2 + 2 + 2 = 7
    assert roofline.causal_pairs(4, 4, True, 0) == 10
    assert roofline.causal_pairs(4, 4, True, 2) == 7
    flops, nbytes, peak, pairs = roofline.flash_cost(1, 4, 4, 2, 1, 8, 2,
                                                     True, 0)
    assert (flops, pairs, peak) == (4 * 2 * 8 * 10, 10, 989e12)
    assert nbytes == (2 * 4 * 2 * 8 + 2 * 4 * 1 * 8) * 2
    flops, nbytes, _ = roofline.attention_cost(2, 16, 4, 2, 8, 2, 10)
    assert flops == 4 * 10 * 2 * 8
    assert nbytes == 2 * 10 * 2 * 8 * 2 + 2 * 2 * 4 * 8 * 2 + 4 * 2 * 16 + 8
    flops, nbytes, _ = roofline.scan_cost(1, 3, 4, 2, 2)
    assert flops == 7 * 3 * 4 * 2
    assert nbytes == (2 * 3 * 4 + 2 * 3 * 2) * 2 + (3 * 4 + 4 * 2) * 4
    assert roofline.bound(67e12, 0, 67e12) == (1.0, "operations")


@pytest.mark.parametrize("shape", [
    dict(flash=(1, 4096, 4096, 36, 4, 128, 2, True, 0),
         attn=(64, 4096, 36, 4, 128, 2, 64 * 2200),
         scan=(1, 2048, 8192, 16, 2)),
    dict(flash=(8, 640, 640, 16, 8, 128, 2, True, 300),
         attn=(8, 1024, 32, 8, 64, 4, 5000),
         scan=(8, 512, 3200, 16, 4))])
def test_agrees_with_the_programs_copy(shape):
    assert roofline.flash_cost(*shape["flash"]) == analysis.flash_cost(
        *shape["flash"])
    assert roofline.attention_cost(*shape["attn"]) == \
        analysis.attention_cost(*shape["attn"])
    assert roofline.scan_cost(*shape["scan"]) == analysis.scan_cost(
        *shape["scan"])
    assert roofline.bound(*analysis.scan_cost(*shape["scan"])) == \
        analysis._bound(*analysis.scan_cost(*shape["scan"]))


@pytest.mark.parametrize("name, params", [("starcoder2-7b", 7_399_051_776),
                                          ("falcon-mamba-7b", 7_272_665_088)])
def test_layer_params_by_hand(name, params):
    """Layers plus embedding and head give the published parameter
    count (7.40 B and 7.27 B, untied)."""
    cfg = spec.read_json(spec.PACKAGE / "configs" / f"{name}.json")
    emb = 2 * cfg["vocab_size"] * cfg["d_model"] + cfg["d_model"]
    assert cfg["num_layers"] * roofline.layer_params(cfg) + emb == params


def test_served_flops_by_hand():
    cfg = dict(d_model=8, num_heads=2, num_kv_heads=1, head_dim=4, d_ff=16,
               ffn_act="gelu", vocab_size=10, num_layers=3)
    per_layer = 8 + 2 * 8 * 2 * 4 + 2 * 8 * 1 * 4 + 8 + 2 * 8 * 16
    assert roofline.layer_params(cfg) == per_layer
    # 5 tokens: 15 causal pairs, 4 * 2 heads * 4 * 3 layers FLOP a pair
    assert roofline.prefill_flops(cfg, 1, 5) == (
        2 * 3 * per_layer * 5 + 96 * 15 + 2 * 8 * 10)
    # two rows at positions 4 and 9: 5 + 10 keys
    assert roofline.decode_flops(cfg, [4, 9]) == (
        2 * (2 * 3 * per_layer + 2 * 8 * 10) + 96 * 15)
