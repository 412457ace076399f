"""Quickstart on the PyTorch/CUDA port: GPTVQ-quantize a weight matrix and
inspect the result (``examples/quickstart.py``'s, through ``repro_torch``).

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

On the card the column sweep and the codebook EM run in the
``vq_assign`` kernels and the packed matmul in ``vq_dequant_matmul``; on
the CPU their plain versions run.
"""
import argparse
import json

import torch

from repro_torch.core import hessian as hes
from repro_torch.core import vq_linear
from repro_torch.core.bpv import VQConfig
from repro_torch.core.gptvq import gptvq_quantize_matrix, layer_error
from repro_torch.core.quant import rtn_quantize
from repro_torch.device import resolve_device

# paper setting: 2D VQ, 2 bits/dim, int8 codebooks, 2.25 bpv total
CFG = VQConfig(d=2, bits_per_dim=2, group_size=1024, em_iters=50,
               codebook_update_iters=25)


def inputs(device, seed: int = 0):
    """A weight matrix (out=256, in=512) and correlated calibration inputs
    (some input dims matter more, as in real activations)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    W = torch.randn((256, 512), generator=gen, device=device)
    X = torch.randn((4096, 512), generator=gen, device=device)
    X[:, :64] *= 4.0
    return W, X


def run(W: torch.Tensor, X: torch.Tensor, cfg: VQConfig = CFG,
        seed: int = 0) -> dict:
    """The example's figures for W (out, in) and X (n, in) f32 on one
    device: the GPTVQ and RTN (2 bits, groups of 64: the same 2.25 bpv)
    layer errors tr(E H E^T), the packed payload, and the relative error
    of a matmul through the packed (fused) path."""
    dev = W.device
    H = hes.finalize(hes.accumulate(hes.init_hessian(W.shape[1],
                                                     device=dev), X))
    U = hes.inv_hessian_cholesky(H)
    gen = torch.Generator(device=dev).manual_seed(seed)
    res = gptvq_quantize_matrix(W, U, cfg, gen)
    Q_rtn = rtn_quantize(W, bits=2, group_size=64)
    vql = vq_linear.quantize_array(W, H, cfg,
                                   generator=torch.Generator(
                                       device=dev).manual_seed(seed))
    payload = sum(t.numel() * t.element_size()
                  for t in (vql.words, vql.codebooks, vql.cb_scale,
                            vql.scale_a, vql.scale_z))
    if vql.scale_block:
        payload += vql.scale_sint.numel() // 2
    x = torch.randn((4, W.shape[1]), generator=gen, device=dev)
    y = vq_linear.fused_matmul(x, vq_linear.prepare_fused(vql))
    y_ref = x @ W.T
    return {"bits_per_value": cfg.bits_per_value,
            "gptvq_layer_error": float(layer_error(W, res.arrays.Q, H)),
            "rtn_layer_error": float(layer_error(W, Q_rtn, H)),
            "payload_bytes": int(payload),
            "payload_bits_per_value": payload * 8 / W.numel(),
            "matmul_rel_err": float(torch.linalg.norm(y - y_ref)
                                    / torch.linalg.norm(y_ref))}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    fig = run(*inputs(dev))
    print(f"GPTVQ @ {fig['bits_per_value']} bpv")
    print(f"  layer error (tr EHE^T): {fig['gptvq_layer_error']:.4f}")
    print(f"  RTN 2b@g64 layer error: {fig['rtn_layer_error']:.4f}")
    print(f"  packed size: {fig['payload_bytes']} bytes "
          f"({fig['payload_bits_per_value']:.3f} bits/value vs 32 fp32)")
    print(f"  matmul relative error through packed path: "
          f"{fig['matmul_rel_err']:.4f}")
    print(json.dumps(fig))
    return fig


if __name__ == "__main__":
    main()
