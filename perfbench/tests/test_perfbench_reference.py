"""The plain references against the port on the CPU at small sizes: the
frozen VQ decode and group plan equal the port's bit for bit, the plain
Qwen2 decoder's logits equal the port's forward (in float32, through its
VQ gather form), and the plain Qwen3-MoE block's Hessians and forward
equal the port's capture and block on weights made by
``perfbench/models``."""
import dataclasses
import json

import pytest
import torch

from tiny import REPO
from perfbench.models import qwen2 as drv, qwen3_moe
from perfbench.reference import ops, qwen2 as decoder_lm, qwen3_moe as moe_ref, vq

CFG = json.loads((REPO / "perfbench/configs/qwen2-72b.json").read_text())


def small(**kw):
    cfg = dict(CFG, hidden_size=64, intermediate_size=160,
               num_attention_heads=4, num_key_value_heads=2,
               num_hidden_layers=2, vocab_size=512,
               max_position_embeddings=128, **kw)
    cfg["assumed"] = dict(CFG["assumed"], head_dim=16)
    return cfg


@pytest.mark.parametrize("r,c", [(64, 64), (160, 64), (64, 160),
                                 (8192, 256), (256, 29568)])
def test_vq_decode_matches_port(r, c):
    from repro_torch.core import vq_linear

    cfg = dict(small(), hidden_size=c, intermediate_size=r)
    raw = drv.weights(cfg, 5, torch.device("cpu"))
    m = raw["layers.0.ffn.w_in"]
    assert (m["r"], m["c"]) == (r, c)
    leaf = drv.port_params(cfg, raw)["layers"][0]["ffn"]["w_in"]
    ours = vq.dequantize(m["words"], m["codebooks"], m["cb_scale"],
                         **{k: m[k] for k in ("r", "c", "d", "k",
                                              "group_cols", "rows_per_band")})
    assert torch.equal(ours, vq_linear.dequantize(leaf, torch.float32))


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 9])
def test_decoder_matches_port_forward(seed):
    from repro_torch.models.model_zoo import build

    cfg = small()
    raw = drv.weights(cfg, seed, torch.device("cpu"))
    f32 = {k: (v.float() if isinstance(v, torch.Tensor) else v)
           for k, v in raw.items()}
    model = build(dataclasses.replace(drv.port_config(cfg), dtype="float32"))
    tokens = torch.randint(0, 512, (2, 40), generator=torch.Generator()
                           .manual_seed(seed % 1000))
    with torch.no_grad():
        port, _, _ = model.forward(drv.port_params(cfg, f32),
                                   {"tokens": tokens})
    pos = torch.arange(40)
    ref = decoder_lm.logits_at(cfg, raw, list(tokens), [pos, pos])
    for i in range(2):
        torch.testing.assert_close(ref[i], port[i], rtol=1e-4, atol=1e-4)


def test_fp8_control_differs_from_f32():
    cfg = small()
    raw = drv.weights(cfg, 3, torch.device("cpu"))
    seq = [torch.arange(1, 33)]
    pos = [torch.arange(32)]
    exact = decoder_lm.logits_at(cfg, raw, seq, pos)[0]
    low = decoder_lm.logits_at(cfg, raw, seq, pos, precision="fp8")[0]
    rel = (low - exact).norm() / exact.norm()
    assert 1e-3 < float(rel) < 0.5


MOE = json.loads((REPO / "perfbench/configs/qwen3-moe-30b-a3b.json")
                 .read_text())


@pytest.mark.parametrize("r,c", [(768, 2048), (2048, 768), (4096, 2048),
                                 (512, 2048), (2048, 4096), (8192, 256),
                                 (256, 29568)])
def test_group_plan_matches_port(r, c):
    from repro_torch.core.bpv import PAPER_SETTINGS
    from repro_torch.core.gptvq import plan_groups

    q = MOE["quantization"]
    assert vq.plan_groups(r, c, q["d"], q["group_size"], q["group_cols"]) \
        == plan_groups(r, c, PAPER_SETTINGS[q["setting"]])


def small_moe():
    cfg = dict(MOE, hidden_size=64, moe_intermediate_size=32,
               num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               num_experts=8, num_experts_per_tok=2, num_hidden_layers=2,
               vocab_size=512, torch_dtype="float32")
    # capacity 1.0: some pairs are dropped at 32 tokens, and the rule shows
    cfg["assumed"] = dict(MOE["assumed"], moe_capacity_factor=1.0)
    return cfg


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5])
def test_moe_block_matches_port(seed):
    from repro_torch.core.adapters import get_adapter
    from repro_torch.core import hessian as hes
    from repro_torch.models import transformer
    from repro_torch.models.model_zoo import build

    cfg = small_moe()
    raw = qwen3_moe.weights(cfg, seed, torch.device("cpu"))
    model = build(qwen3_moe.port_config(cfg))
    params = qwen3_moe.port_params(cfg, raw)
    ids = torch.randint(0, 512, (3, 32), generator=torch.Generator()
                        .manual_seed(seed % 1000))
    blk = get_adapter(model, params).blocks()[0]
    x = transformer.embed_tokens(params, model.cfg, ids)
    taps = blk.capture(x, {}, frozenset({"attn", "mlp"}))
    with ops.full_f32():
        ref = moe_ref.hessians(cfg, raw, 0, moe_ref.embed(raw, ids),
                               list(range(8)), ops.Ops("f32"))
    for t in ("attn_in", "attn_out_in"):
        torch.testing.assert_close(hes.finalize(taps[t]), ref[t],
                                   rtol=1e-4, atol=1e-6)
    for tap in ("experts_in", "experts_out"):
        Hs, n = taps[tap]
        for e in range(8):
            torch.testing.assert_close(Hs[e] / n[e].clamp(min=1.0),
                                       ref[f"{tap}.{e}"], rtol=1e-4,
                                       atol=1e-6)
    y, _, _ = transformer._block_apply(params["layers"][0], model.cfg,
                                       "moe", x, pos=0)
    with ops.full_f32():
        y_ref = moe_ref.advance(cfg, raw, 0, moe_ref.embed(raw, ids),
                                moe_ref.dense_mats(raw, 0), ops.Ops("f32"))
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-5)
