"""The inputs of a run, made from ``--seed`` on the device: the draws that
every architecture's weight maker (``perfbench/models/<arch>.py``) uses,
a traffic mix's requests and a calibration set's token ids. Both sides get
the same: the program its parameter tree assembled from these tensors, the
reference the tensors themselves (made again from the seed once the window
has closed).

Weights come in a few large calls on a ``torch.Generator`` of the device,
in the types they are served in: one draw for every dense leaf, and for
packed matrices one for their code words, one for their int8 codebooks
and one for the codebooks' scales, each then cut into its leaves. Nothing
here imports the program.
"""
from __future__ import annotations

import math

import torch

from perfbench.reference import vq

INT8_STD = math.sqrt((255 ** 2 - 1) / 12.0)  # uniform on [-127, 127]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def gen(device, seed: int, stream: int) -> torch.Generator:
    """A generator for one stream of a run's draws (weights 0, traffic 1,
    calibration 2), from a seed of up to 64 bits."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 8 + stream) % (2 ** 63))


@torch.no_grad()
def dense(leaves: list, g: torch.Generator, device, dtype) -> dict:
    """{name: tensor} for ``leaves`` [(name, shape, std, mean)], drawn as
    one normal tensor and cut: each leaf mean + std * N(0, 1)."""
    total = sum(math.prod(s) for _, s, _, _ in leaves)
    flat = torch.randn((total,), generator=g, device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape, std, mean in leaves:
        t = flat[at:at + math.prod(shape)].view(shape)
        t.mul_(std).add_(mean)
        out[name] = t
        at += t.numel()
    return out


def packed_layout(quant: dict, r: int, c: int) -> dict:
    """The packed layout of an (r out, c in) matrix at the configuration's
    ``quantization`` settings."""
    d = quant["d"]
    k = int(round(2 ** (d * quant["bits_per_dim"])))
    cg, rg = vq.plan_groups(r, c, d, quant["group_size"], quant["group_cols"])
    code_bits = max(1, (k - 1).bit_length())
    lanes = 32 // vq.container_bits(code_bits)
    return {"r": r, "c": c, "d": d, "k": k, "group_cols": cg,
            "rows_per_band": rg, "n_words": r * (c // d) // lanes,
            "words_shape": ((r, c // d // lanes) if (c // d) % lanes == 0
                            else (1, r * (c // d) // lanes)),
            "n_cb": (c // cg) * (r // rg), "cb_shape": (c // cg, r // rg)}


@torch.no_grad()
def packed(named_layouts: list, g: torch.Generator, device) -> dict:
    """{name: {"words", "codebooks", "cb_scale", r, c, d, k, group_cols,
    rows_per_band}} for ``named_layouts`` [(name, packed_layout)]: random
    codes and int8 codebooks, each codebook's scale within a factor of 3
    of the mean, so that a weight's std is about 1/sqrt(c), as a trained
    model's."""
    n_words = sum(lo["n_words"] for _, lo in named_layouts)
    n_cb = sum(lo["n_cb"] * lo["k"] * lo["d"] for _, lo in named_layouts)
    n_sc = sum(lo["n_cb"] for _, lo in named_layouts)
    words = torch.randint(-2 ** 31, 2 ** 31, (n_words,), generator=g,
                          device=device, dtype=torch.int32)
    cbs = torch.randint(-127, 128, (n_cb,), generator=g, device=device,
                        dtype=torch.int8)
    scales = torch.rand((n_sc,), generator=g, device=device,
                        dtype=torch.float32)
    out = {}
    aw = ac = asc = 0
    for name, lo in named_layouts:
        nw, nc, ns = lo["n_words"], lo["n_cb"] * lo["k"] * lo["d"], lo["n_cb"]
        sc = scales[asc:asc + ns].view(lo["cb_shape"])
        sc.add_(0.5).mul_(1.0 / (math.sqrt(lo["c"]) * INT8_STD))
        out[name] = {
            "words": words[aw:aw + nw].view(lo["words_shape"]),
            "codebooks": cbs[ac:ac + nc].view(*lo["cb_shape"], lo["k"],
                                              lo["d"]),
            "cb_scale": sc,
            **{k: lo[k] for k in ("r", "c", "d", "k", "group_cols",
                                  "rows_per_band")}}
        aw, ac, asc = aw + nw, ac + nc, asc + ns
    return out


def _quantiles(n: int, lo: int, hi: int, dist: str) -> torch.Tensor:
    """n sizes at the midpoints of n equal-probability slices of the
    distribution."""
    u = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    if dist == "loguniform":
        v = torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    elif dist == "uniform":
        v = lo + u * (hi - lo)
    else:
        raise ValueError(f"size distribution {dist!r}")
    return torch.clamp(torch.floor(v), lo, hi).to(torch.int64)


def requests(mix: dict, vocab: int, seed: int, device) -> list:
    """Each client's list of (prompt ids (int32 numpy), output tokens).

    The sizes are one schedule for every seed: request i of every client
    makes round i, and each round holds the mix's fixed quantile set of
    prompt sizes and of output sizes, shuffled over the clients once by
    the mix's ``schedule_seed``. A client's first request stands in for
    one already under way when the window opens: its output is a fraction
    of its drawn size, the fractions spread evenly over the clients (so
    completions are staggered from the start), and the first
    ``len(warm_prompts)`` clients' first prompts have the sizes the mix
    names, so that warm-up meets every prefill chunk width. The seed
    relabels the clients and draws every token id, on the device in one
    call: every seed does the same work in another order."""
    clients, per = mix["clients"], mix["requests_per_client"]
    sched = torch.Generator().manual_seed(int(mix.get("schedule_seed", 0)))

    def rounds(spec):
        sizes = _quantiles(clients, spec["lo"], spec["hi"], spec["dist"])
        return torch.stack([sizes[torch.randperm(clients, generator=sched)]
                            for _ in range(per)], dim=1)  # (clients, per)

    p_sizes, o_sizes = rounds(mix["prompt_tokens"]), rounds(
        mix["output_tokens"])
    frac = (torch.randperm(clients, generator=sched).to(torch.float64)
            + 0.5) / clients
    for j, size in enumerate(list(mix.get("warm_prompts", []))[:clients]):
        p_sizes[j, 0] = size
    o_sizes[:, 0] = torch.clamp(torch.ceil(o_sizes[:, 0] * frac), min=1)
    g = gen(device, seed, 1)
    order = torch.randperm(clients, generator=g, device=device).cpu()
    p_sizes, o_sizes = p_sizes[order], o_sizes[order]
    ids = torch.randint(0, vocab, (int(p_sizes.sum()),), generator=g,
                        device=device, dtype=torch.int32).cpu().numpy()
    out, at = [], 0
    for j in range(clients):
        row = []
        for i in range(per):
            ps = int(p_sizes[j, i])
            row.append((ids[at:at + ps], int(o_sizes[j, i])))
            at += ps
        out.append(row)
    return out


def calibration(mix: dict, vocab: int, seed: int, device) -> torch.Tensor:
    """(sequences, tokens) int64 calibration ids, uniform over the
    vocabulary, drawn on the device in one call."""
    g = gen(device, seed, 2)
    return torch.randint(0, vocab, (mix["sequences"], mix["tokens"]),
                         generator=g, device=device, dtype=torch.int64)
