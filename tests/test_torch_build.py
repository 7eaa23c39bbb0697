"""The layer-at-a-time serving build (``serving.engine.build_params`` with
``core.quant_plan.LayerPacker``) against the whole-tree one it replaces,
``pack_for_serving(init_model(gen, cfg), cfg, rt)``, on the CPU: the same
tree, every leaf bit for bit (``packed``, ``scale`` and the ``packed_km``
twins, the float masters the plan keeps), the same packed sites.

  * reduced qwen2-0.5b under a uniform plan, at 3 layers so that wk / wv
    (64 x 32 = 2,048 elements a block) pack only because the size rule
    counts the layer-stacked leaf (6,144);
  * the same under a per-layer mixed plan (a float block 0, grouped W4A16
    FFNs in block 1): the stack splits into per-block trees and the size
    rule counts each block alone, so wk / wv stay masters;
  * reduced recurrentgemma-9b: (R, R, A) units and an (R, R) tail, the
    tail packing under its own sites;
  * reduced starcoder2-7b with its untied lm_head packed (and its twin);
  * reduced arctic-480b and llama4-maverick: expert stacks packed one
    expert at a time, per output channel, without a twin; and a plan whose
    experts run on the fly (int_sim), which keeps their masters.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import Runtime, get_config  # noqa: E402
from repro_torch.core import quant_plan as qp  # noqa: E402
from repro_torch.models.transformer import init_model  # noqa: E402
from repro_torch.serving.engine import build_params  # noqa: E402

MIXED = "block[1].ffn.*=w4a16_packed/g32;block[0].*=float;*=w4a4_packed"
CASES = {
    "qwen2-0.5b uniform": ("qwen2-0.5b", 3, dict(quant_backend="w4a4_packed")),
    "qwen2-0.5b mixed": ("qwen2-0.5b", 3, dict(quant_plan=MIXED)),
    "recurrentgemma-9b": ("recurrentgemma-9b", None,
                          dict(quant_backend="w4a4_packed")),
    "starcoder2-7b, packed lm_head": ("starcoder2-7b", 2,
                                      dict(quant_plan="*=w4a4_packed")),
    "arctic-480b": ("arctic-480b", None, dict(quant_backend="w4a4_packed")),
    "llama4-maverick": ("llama4-maverick-400b-a17b", 2,
                        dict(quant_backend="w4a4_packed")),
    "arctic-480b, on-the-fly experts": (
        "arctic-480b", None,
        dict(quant_plan="moe.experts=int_sim;*=w4a4_packed;lm_head=float")),
}


def _cfg(arch, layers):
    cfg = get_config(arch)
    return cfg.reduced(n_layers=layers) if layers else cfg.reduced()


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict / list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((f"[{i}]", v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def _reference(cfg, rt, seed):
    return qp.pack_for_serving(
        init_model(torch.Generator().manual_seed(seed), cfg), cfg, rt)


@pytest.mark.parametrize("case", list(CASES))
def test_layer_at_a_time_build_equals_the_whole_tree_build(case):
    arch, layers, kw = CASES[case]
    cfg, rt = _cfg(arch, layers), Runtime(**kw)
    want, got = _flat(_reference(cfg, rt, 5)), _flat(
        build_params(cfg, rt, seed=5, device="cpu"))
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, path
        assert torch.equal(got[path], leaf), path
    assert any(p.endswith("/packed_km") for p in got)
    if "lm_head=" not in kw.get("quant_plan", "lm_head=") and \
            not cfg.tie_embeddings:
        assert "/lm_head/w/packed_km" in got


@pytest.mark.parametrize("case", list(CASES))
def test_layer_packer_logs_the_plan_packers_sites(case):
    arch, layers, kw = CASES[case]
    cfg, rt = _cfg(arch, layers), Runtime(**kw)
    plan = qp.active_plan(cfg, rt)
    want, got = {}, {}
    qp.plan_pack_tree(init_model(torch.Generator().manual_seed(1), cfg), cfg,
                      plan, site_log=want)
    init_model(torch.Generator().manual_seed(1), cfg,
               qp.LayerPacker(cfg, plan, site_log=got))
    assert got == want and want


def test_the_size_rule_counts_the_stack_only_when_it_is_kept():
    cfg = _cfg("qwen2-0.5b", 3)
    uniform = build_params(cfg, Runtime(quant_backend="w4a4_packed"),
                           device="cpu")
    mixed = build_params(cfg, Runtime(quant_plan=MIXED), device="cpu")
    assert "packed" in uniform["layers"]["u0"]["attn"]["wk"]
    assert isinstance(mixed["layers"], list) and len(mixed["layers"]) == 3
    assert isinstance(mixed["layers"][2]["attn"]["wk"], torch.Tensor)
    assert "packed" in mixed["layers"][2]["attn"]["wq"]
    assert isinstance(mixed["layers"][0]["attn"]["wq"], torch.Tensor)
    assert mixed["layers"][1]["ffn"]["w_in"]["scale"].ndim == 3   # grouped


@pytest.mark.parametrize("arch", ["arctic-480b", "llama4-maverick-400b-a17b"])
def test_expert_stacks_pack_per_channel_without_a_twin(arch):
    cfg = _cfg(arch, None)
    p = build_params(cfg, Runtime(quant_plan="*=w4a16_packed/g32"),
                     device="cpu")
    E, D = cfg.n_experts, cfg.d_model
    F = cfg.d_ff_expert or cfg.d_ff
    for name, (K, N) in (("w_in", (D, F)), ("w_out", (F, D))):
        leaf = p["layers"]["u0"]["moe"]["experts"][name]
        assert set(leaf) == {"packed", "scale"}
        assert leaf["packed"].shape == (1, E, K, N // 2)
        assert leaf["scale"].shape == (1, E, 1, N)          # per channel
    assert isinstance(p["layers"]["u0"]["moe"]["router"]["w"], torch.Tensor)
    side = "dense_ffn" if cfg.moe_dense_ff else "shared"
    assert p["layers"]["u0"][side]["w_in"]["scale"].ndim == 4  # grouped
