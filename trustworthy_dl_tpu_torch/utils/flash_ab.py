"""This checkout's flash attention forward (B2) and backward (B3) against
another build of them, in one process on one card.

    python -m trustworthy_dl_tpu_torch.utils.flash_ab OTHER.cu [--reps 25]

``OTHER.cu`` is another version of ``ops/csrc/flash_attention.cu`` (for
example the parent commit's, from ``git show <commit>:<path>``): it is
built with the same ``nvcc`` flags into a library of its own beside the
checkout's kernels, and its ``tddl_flash_fwd`` is called through the same
C signature.  At GPT-2 small's training shape [96, 1024, 64] and at D = 32
and 128 (bf16, causal), both builds are held against ``flash_fwd_plain``
with ``chip_smoke.py``'s tolerances, then timed in turns (this, other,
other, this) with the L2 flushed before each launch: the median of
per-launch CUDA-event timings (``ms``, which also holds the host's
dispatch whenever the card waits for it) and the profiler's device time
of the kernel (``device_ms``), beside SDPA's on the same inputs;
``this_vs_other_max_abs``: the builds' largest difference in o and lse.
One JSON line per shape.

Then the backward, one JSON line per shape (``"pass": "bwd"``): both
builds' ``tddl_flash_bwd_dq`` and ``tddl_flash_bwd_dkv`` held against
``flash_bwd_dq_plain`` / ``flash_bwd_dkv_plain`` (the checkout's o, lse
and Delta; ``*_err_over_tolerance``: each output's largest error over its
tolerance; ``this_vs_other_max_abs``: the builds' largest difference),
then in turns (this, other, other, this) the dq kernel, the
dk/dv kernel, and the whole backward of each build as
``FlashAttention.backward`` runs it (``*_pair``: the Delta reduction, dq,
dk/dv), beside the Delta reduction alone (``delta``) and SDPA's whole
backward (``sdpa_bwd``: ``torch.autograd.grad`` through causal SDPA,
every kernel of it; ``sdpa_bwd_kernels`` names them, so the record says
which backend torch picked).

Then the non-causal instances (``causal=False``, the ring attention's
chunks), one JSON line per shape (``"pass": "full"``) at the ring's chunk
[96, 256, 64] and at the same three shapes, an A/B as well: both builds'
``tddl_flash_fwd_full`` held against ``flash_fwd_plain(causal=False)``
(``*_fwd_err_over_tolerance`` of o, ``*_lse_max_abs_err``,
``*_fwd_within_tolerance`` with the smoke's 1e-3 on lse), and both
builds' ``tddl_flash_bwd_dq_full`` and ``tddl_flash_bwd_dkv_full``
against the twins (``*_err_over_tolerance``; ``this_vs_other_max_abs``,
o, lse and Delta included), then in turns (this, other, other, this) the
forward, the dq kernel, the dk/dv kernel and the whole non-causal
backward as ``FlashChunk.backward`` runs it under an lse cotangent
(``*_pair``): this build's two launches, dq computing Delta, against the
other's Delta - dlse reduction, dq and dk/dv.  An other build whose
``tddl_flash_bwd_dq_full`` still takes Delta (seven arrays, the parent's
C signature, read off its source) gets the reduction; one that takes o
and dlse computes Delta itself.  Beside them SDPA's forward and whole backward
with ``is_causal=False``, the forward's bound (``fwd_bound_ms``: q, k, v
read and o, lse written once at the card's 3.35 TB/s, or its two [T, T] x
D products at 989 TFLOP/s, whichever is longer; ``fwd_bound_by``) and
each build's forward TFLOP/s on device time; ``this_fwd_kernels`` and
``other_fwd_kernels``: the profiler's names of the kernel each build's
forward launches (the wgmma instance at D = 64 and 128, the mma.sync one
at D = 32); ``this_pair_kernels``: the profiler's names of
the kernels this build's pair launches (its two, and nothing else:
``this_pair_two_kernels``); the host's microseconds to enqueue this
build's pair (``this_pair_host_us``) and the Delta - dlse reduction
alone (``delta_reduction_host_us``).  Then the card's name and power
limit.  About two minutes for the three passes, the other build's nvcc
included.  ``--passes full`` (or any of ``causal``, ``bwd``, ``full``)
runs only those passes: a variant of the checkout's own kernel, an edited
copy of the source, against the checkout's.

    python -m trustworthy_dl_tpu_torch.utils.flash_ab OTHER.cu --rising

prints instead one JSON line per shape and seed (:func:`rising_record`):
both builds' non-causal forward on keys scaled by their index, against
the plain twin, the exact f64 softmax and :func:`tiled_fwd_reference`.

    python -m trustworthy_dl_tpu_torch.utils.flash_ab --f64

prints instead one JSON line (:func:`f64_record`): the checkout's dk at
[48, 1024, 128], from the inputs the A/B draws there, against the f32
twin, an f64 twin, a twin with the kernel's own exp2 formula, one-ulp
perturbations of that twin's P and dP, and the exact f64 dk.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

SHAPES = ((96, 1024, 64), (96, 1024, 32), (48, 1024, 128))
PASSES = ("causal", "bwd", "full")
#: The non-causal pass's shapes: the ring's chunk, then SHAPES.
FULL_SHAPES = ((96, 256, 64),) + SHAPES
#: f32 ulps by which :func:`f64_record` moves P and dP at most.
ULP_MOVES = (1, 4, 16)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, nargs="?",
                        help="another flash_attention.cu")
    parser.add_argument("--reps", type=int, default=25)
    parser.add_argument("--passes", nargs="+", choices=PASSES,
                        default=list(PASSES),
                        help="which passes to run (default: all three)")
    parser.add_argument("--f64", action="store_true",
                        help="only the dk record against f64 twins")
    parser.add_argument("--rising", action="store_true",
                        help="only the non-causal forward on keys scaled "
                             "by their index, against three references")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ab: needs a CUDA card", file=sys.stderr)
        return 1
    if args.f64:
        print(json.dumps(f64_record()), flush=True)
        return 0
    if args.other is None:
        parser.error("give another flash_attention.cu, or --f64")
    import torch.nn.functional as F

    from trustworthy_dl_tpu_torch.ops import flash_attention as fa
    from trustworthy_dl_tpu_torch.utils import kernel_ab as ab

    lib = ab.other_library(args.other, "flash_attention")
    dev = torch.device("cuda")
    flush = ab.flush_buffer(dev)

    def other_fwd(q, k, v):
        o = torch.empty_like(q)
        lse = torch.empty(q.shape[:2], dtype=torch.float32, device=dev)
        err = lib.tddl_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), lse.data_ptr(), *q.shape,
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{args.other}: CUDA error {err}")
        return o, lse

    def other_call(entry, *tensors):
        q = tensors[0]
        err = getattr(lib, entry)(*[a.data_ptr() for a in tensors], *q.shape,
                                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{args.other}: {entry}: CUDA error {err}")

    if args.rising:
        for record in rising_record(fa, other_call):
            print(json.dumps(record), flush=True)
        print(ab.card_line())
        return 0

    def other_dq(q, k, v, do, lse, delta):
        dq = torch.empty_like(q)
        other_call("tddl_flash_bwd_dq", q, k, v, do, lse, delta, dq)
        return dq

    def other_dkv(q, k, v, do, lse, delta):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        other_call("tddl_flash_bwd_dkv", q, k, v, do, lse, delta, dk, dv)
        return dk, dv

    takes_o = dq_full_takes_o(args.other)
    if not takes_o:   # the parent's C signature: q, k, v, dO, lse, Delta, dq
        lib.tddl_flash_bwd_dq_full.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p])

    def other_full(q, k, v, do, o, lse, dlse):
        """The other build's non-causal backward as its ``_backward`` runs
        it: (dq, delta, dk, dv)."""
        dq, dk, dv = (torch.empty_like(a) for a in (q, k, v))
        if takes_o:
            delta = torch.empty(q.shape[:2], dtype=torch.float32, device=dev)
            other_call("tddl_flash_bwd_dq_full", q, k, v, do, o, lse, dlse,
                       delta, dq)
        else:
            delta = fa.row_delta(do, o, dlse)
            other_call("tddl_flash_bwd_dq_full", q, k, v, do, lse, delta, dq)
        other_call("tddl_flash_bwd_dkv_full", q, k, v, do, lse, delta, dk, dv)
        return dq, delta, dk, dv

    def worst(got, ref):
        """The largest error over its tolerance (at most 1 is within)."""
        err = (got.float() - ref.float()).abs()
        return float((err / (2e-3 + 2.0 ** -7 * ref.float().abs())).max())

    gen = torch.Generator(device=dev).manual_seed(4)
    for bh, t, d in SHAPES if "causal" in args.passes else ():
        q, k, v = (torch.randn(bh, t, d, device=dev, generator=gen).to(
            torch.bfloat16) for _ in range(3))
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v)
        arms = {"this": lambda: fa.flash_attention_fwd(q, k, v),
                "other": lambda: other_fwd(q, k, v)}
        record = {"bhtd": [bh, t, d]}
        outs = {}
        for name, fn in arms.items():
            o, lse = outs[name] = fn()
            torch.cuda.synchronize()
            err = (o.float() - o_ref.float()).abs()
            record[f"{name}_within_tolerance"] = bool(
                (err <= 2e-3 + 2.0 ** -7 * o_ref.float().abs()).all()
                and float((lse - lse_ref).abs().max()) <= 1e-3)
        record["this_vs_other_max_abs"] = {
            n: float((a.float() - b.float()).abs().max())
            for n, a, b in zip(("o", "lse"), outs["this"], outs["other"])}
        del outs
        q4, k4, v4 = (a.view(1, bh, t, d) for a in (q, k, v))
        arms["sdpa"] = lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True)
        record.update(ab.in_turns(arms, ("this", "other", "other", "this",
                                         "sdpa"), flush, args.reps))
        flops = 2 * bh * d * (t * (t + 1) // 2) * 2
        record["this_device_tflops"] = flops / (
            min(record["this_device_ms"]) * 1e-3) / 1e12
        print(json.dumps(record), flush=True)
    for bh, t, d in SHAPES if "bwd" in args.passes else ():
        print(json.dumps(backward_record(
            fa, ab, F, flush, args.reps, gen, bh, t, d, other_dq, other_dkv,
            worst)), flush=True)
    for bh, t, d in FULL_SHAPES if "full" in args.passes else ():
        print(json.dumps(full_record(
            fa, ab, F, flush, args.reps, gen, bh, t, d, worst, other_full,
            other_call, takes_o)), flush=True)
    print(ab.card_line())
    return 0


def dq_full_takes_o(source: Path) -> bool:
    """Whether ``source``'s ``tddl_flash_bwd_dq_full`` takes o and dlse
    (nine arrays: it computes Delta itself) rather than Delta (seven)."""
    sig = re.search(r"int tddl_flash_bwd_dq_full\(([^)]*)\)",
                    source.read_text())
    if sig is None:
        raise ValueError(f"{source}: no tddl_flash_bwd_dq_full")
    return sig.group(1).count("void*") - 1 == 9


def full_record(fa, ab, F, flush, reps, gen, bh, t, d, worst, other_full,
                other_call, takes_o):
    """One shape of the non-causal pass (module docstring)."""
    dev = flush.device
    q, k, v, do = (torch.randn(bh, t, d, device=dev, generator=gen).to(
        torch.bfloat16) for _ in range(4))
    dlse = 0.5 * torch.randn(bh, t, device=dev, generator=gen)

    def other_fwd():
        o = torch.empty_like(q)
        lse = torch.empty(q.shape[:2], dtype=torch.float32, device=dev)
        other_call("tddl_flash_fwd_full", q, k, v, o, lse)
        return o, lse

    o, lse = fa.flash_attention_fwd(q, k, v, False)
    fwd = {"this": (o, lse), "other": other_fwd()}
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, False)
    refs = fa.flash_bwd_dq_plain(q, k, v, do, lse, None, False, o, dlse)
    refs = (*refs, *fa.flash_bwd_dkv_plain(q, k, v, do, lse, refs[1], False))
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, do, lse, None, False, o,
                                          dlse)
    outs = {"this": (dq, delta, *fa.flash_attention_bwd_dkv(
        q, k, v, do, lse, delta, False)),
        "other": other_full(q, k, v, do, o, lse, dlse)}
    torch.cuda.synchronize()
    names = ("dq", "delta", "dk", "dv")
    record = {"pass": "full", "bhtd": [bh, t, d],
              "other_computes_delta": takes_o}
    for build, (b_o, b_lse) in fwd.items():
        ratio = worst(b_o, o_ref)
        lse_err = float((b_lse - lse_ref).abs().max())
        record[f"{build}_fwd_err_over_tolerance"] = ratio
        record[f"{build}_lse_max_abs_err"] = lse_err
        record[f"{build}_fwd_within_tolerance"] = ratio <= 1.0 \
            and lse_err <= 1e-3
    for build, got in outs.items():
        ratios = {n: worst(a, b) for n, a, b in zip(names, got, refs)}
        record[f"{build}_err_over_tolerance"] = ratios
        record[f"{build}_within_tolerance"] = max(ratios.values()) <= 1.0
    record["this_vs_other_max_abs"] = {
        n: float((a.float() - b.float()).abs().max())
        for n, a, b in zip(("o", "lse", *names), (*fwd["this"], *outs["this"]),
                           (*fwd["other"], *outs["other"]))}
    del o_ref, lse_ref, refs, outs, dq, fwd
    other_delta = fa.row_delta(do, o, dlse)

    def other_dq():
        dq = torch.empty_like(q)
        if takes_o:
            other_call("tddl_flash_bwd_dq_full", q, k, v, do, o, lse, dlse,
                       torch.empty_like(delta), dq)
        else:
            other_call("tddl_flash_bwd_dq_full", q, k, v, do, lse,
                       other_delta, dq)
        return dq

    def other_dkv():
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        other_call("tddl_flash_bwd_dkv_full", q, k, v, do, lse, other_delta,
                   dk, dv)
        return dk, dv

    def this_pair():
        return fa._backward(q, k, v, o, lse, do, False, dlse)

    q4, k4, v4 = (a.view(1, bh, t, d).clone().requires_grad_()
                  for a in (q, k, v))
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=False)
    do4 = do.view(1, bh, t, d)
    arms = {"this_dq": lambda: fa.flash_attention_bwd_dq(
                q, k, v, do, lse, None, False, o, dlse),
            "other_dq": other_dq,
            "this_dkv": lambda: fa.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, False),
            "other_dkv": other_dkv,
            "this_pair": this_pair,
            "other_pair": lambda: other_full(q, k, v, do, o, lse, dlse),
            "this_fwd": lambda: fa.flash_attention_fwd(q, k, v, False),
            "other_fwd": other_fwd,
            "sdpa_fwd": lambda: F.scaled_dot_product_attention(
                q4.detach(), k4.detach(), v4.detach(), is_causal=False),
            "sdpa_bwd": lambda: torch.autograd.grad(
                out4, (q4, k4, v4), do4, retain_graph=True)}
    order = [f"{b}_{kind}" for kind in ("fwd", "dq", "dkv", "pair")
             for b in ("this", "other", "other", "this")]
    record.update(ab.in_turns(
        arms, (*order, "sdpa_fwd", "sdpa_bwd"), flush, reps,
        launches={"this_fwd": 1, "other_fwd": 1, "this_dq": 1,
                  "other_dq": 1, "this_dkv": 1, "other_dkv": 1,
                  "this_pair": 2}))
    # The host's enqueue: this build's whole pair through the wrappers,
    # beside the Delta - dlse reduction alone, which it no longer runs.
    record["this_pair_host_us"] = ab.host_us(this_pair)
    record["delta_reduction_host_us"] = ab.host_us(
        lambda: fa.row_delta(do, o, dlse))
    record["this_pair_kernels"] = ab.kernel_names(this_pair, flush)
    record["this_pair_two_kernels"] = (
        len(record["this_pair_kernels"]) == 2
        and all("flash_" in n for n in record["this_pair_kernels"]))
    record["sdpa_bwd_kernels"] = ab.kernel_names(arms["sdpa_bwd"], flush)
    for build in ("this", "other"):
        record[f"{build}_fwd_kernels"] = ab.kernel_names(
            arms[f"{build}_fwd"], flush)
    best = {name: min(record[f"{name}_device_ms"]) for name in arms}
    flops = 2 * bh * d * t * t
    for build in ("this", "other"):
        record[f"{build}_fwd_over_sdpa_fwd"] = (best[f"{build}_fwd"]
                                                / best["sdpa_fwd"])
        record[f"{build}_fwd_device_tflops"] = 2 * flops / (
            best[f"{build}_fwd"] * 1e-3) / 1e12
        record[f"{build}_pair_over_sdpa_bwd"] = (
            best[f"{build}_pair"] / best["sdpa_bwd"])
    for kind in ("fwd", "dq", "dkv", "pair"):
        record[f"other_over_this_{kind}"] = (best[f"other_{kind}"]
                                             / best[f"this_{kind}"])
    # The forward's least time: q, k, v read and o, lse written once, or
    # its two [T, T] x D products at the bf16 peak.
    t_bytes = (4 * bh * t * d * 2 + bh * t * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * flops / BF16_FLOPS * 1e3
    record["fwd_bound_ms"] = max(t_bytes, t_ops)
    record["fwd_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    record["this_dq_device_tflops"] = 3 * flops / (best["this_dq"] * 1e-3) \
        / 1e12
    record["this_dkv_device_tflops"] = 4 * flops / (
        best["this_dkv"] * 1e-3) / 1e12
    return record


def backward_record(fa, ab, F, flush, reps, gen, bh, t, d, other_dq,
                    other_dkv, worst):
    """One shape of the backward A/B (module docstring)."""
    dev = flush.device
    q, k, v, do = (torch.randn(bh, t, d, device=dev, generator=gen).to(
        torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)

    def delta_of():
        return (do.float() * o.float()).sum(dim=-1)

    delta = delta_of()
    args = (q, k, v, do, lse, delta)
    dq_ref = fa.flash_bwd_dq_plain(*args)
    dk_ref, dv_ref = fa.flash_bwd_dkv_plain(*args)
    record = {"pass": "bwd", "bhtd": [bh, t, d]}
    outs = {}
    for name, dq_fn, dkv_fn in (
            ("this", fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv),
            ("other", other_dq, other_dkv)):
        outs[name] = (dq_fn(*args), *dkv_fn(*args))
        torch.cuda.synchronize()
        ratios = {out: worst(got, ref) for out, got, ref in zip(
            ("dq", "dk", "dv"), outs[name], (dq_ref, dk_ref, dv_ref))}
        record[f"{name}_within_tolerance"] = max(ratios.values()) <= 1.0
        record[f"{name}_err_over_tolerance"] = ratios
    # The two builds against each other, where both differ from the twin.
    record["this_vs_other_max_abs"] = {
        out: float((a.float() - b.float()).abs().max())
        for out, a, b in zip(("dq", "dk", "dv"), outs["this"], outs["other"])}
    del dq_ref, dk_ref, dv_ref, outs

    def pair(dq_fn, dkv_fn):
        def run():
            dl = delta_of()
            return dq_fn(q, k, v, do, lse, dl), dkv_fn(q, k, v, do, lse, dl)
        return run

    q4, k4, v4 = (a.view(1, bh, t, d).clone().requires_grad_()
                  for a in (q, k, v))
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    do4 = do.view(1, bh, t, d)

    def sdpa_bwd():
        return torch.autograd.grad(out4, (q4, k4, v4), do4,
                                   retain_graph=True)

    arms = {"this_dq": lambda: fa.flash_attention_bwd_dq(*args),
            "other_dq": lambda: other_dq(*args),
            "this_dkv": lambda: fa.flash_attention_bwd_dkv(*args),
            "other_dkv": lambda: other_dkv(*args),
            "this_pair": pair(fa.flash_attention_bwd_dq,
                              fa.flash_attention_bwd_dkv),
            "other_pair": pair(other_dq, other_dkv),
            "delta": delta_of, "sdpa_bwd": sdpa_bwd}
    order = [f"{b}_{kind}" for kind in ("dq", "dkv", "pair")
             for b in ("this", "other", "other", "this")]
    record.update(ab.in_turns(
        arms, (*order, "delta", "sdpa_bwd"), flush, reps,
        launches={"this_dq": 1, "other_dq": 1, "this_dkv": 1,
                  "other_dkv": 1}))
    record["sdpa_bwd_kernels"] = ab.kernel_names(sdpa_bwd, flush)
    best = {name: min(record[f"{name}_device_ms"]) for name in arms}
    for build in ("this", "other"):
        record[f"{build}_pair_over_sdpa_bwd"] = (
            best[f"{build}_pair"] / best["sdpa_bwd"])
    record["other_over_this_dq"] = best["other_dq"] / best["this_dq"]
    record["other_over_this_dkv"] = best["other_dkv"] / best["this_dkv"]
    return record


def tiled_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """The non-causal forward's o in f64 as the TPU kernel computes it:
    over 64-key tiles, P = exp(s - m) against the running max m, rounded
    to bf16 before P.V, l summed over the unrounded P."""
    bh, t, d = q.shape
    s = torch.einsum("btd,bsd->bts", q.double(), k.double()) / d ** 0.5
    m = torch.full((bh, t, 1), -1e300, dtype=torch.float64, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(bh, t, d, dtype=torch.float64, device=q.device)
    for j in range(0, t, 64):
        sj = s[..., j:j + 64]
        m_new = torch.maximum(m, sj.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(sj - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum(
            "bts,bsd->btd", p.to(torch.bfloat16).double(),
            v[:, j:j + 64].double())
        m = m_new
    return acc / l


def flash_inputs(bh, t, d, seed, rising=False, device="cuda"):
    """q, k, v, dO bf16 [bh, t, d] from ``seed``; ``rising`` scales key row
    s by 1 + s / 64, so the scores' spread grows along the key axis and
    the running max moves on nearly every key tile."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(bh, t, d, device=device, generator=gen)
                   for _ in range(4))
    if rising:
        k = k * (1.0 + torch.arange(t, device=device) / 64.0)[:, None]
    return [a.to(torch.bfloat16) for a in (q, k, v, do)]


def rising_record(fa, other_call, shapes=((2, 1024, 128), (2, 1024, 64),
                                          (4, 192, 64)),
                  seeds=range(8, 14)):
    """For each shape and seed, both builds' ``tddl_flash_fwd_full`` on
    :func:`flash_inputs` with ``rising`` (as the card tests draw them):
    each o's largest error over the card tolerance (atol 2e-3 + rtol
    2^-7) against the plain twin, the exact f64 softmax and
    :func:`tiled_fwd_reference`, the twin's own against the last two,
    and the builds' largest difference."""
    for bh, t, d in shapes:
        for seed in seeds:
            q, k, v, _ = flash_inputs(bh, t, d, seed, rising=True)
            other = torch.empty_like(q)
            other_lse = torch.empty(q.shape[:2], dtype=torch.float32,
                                    device=q.device)
            other_call("tddl_flash_fwd_full", q, k, v, other, other_lse)
            outs = {"this": fa.flash_attention_fwd(q, k, v, False)[0],
                    "other": other,
                    "twin": fa.flash_fwd_plain(q, k, v, False)[0]}
            s = torch.einsum("btd,bsd->bts", q.double(), k.double()) \
                / d ** 0.5
            refs = {"twin": outs["twin"].double(),
                    "exact": torch.einsum("bts,bsd->btd", torch.softmax(
                        s, -1), v.double()),
                    "tiled": tiled_fwd_reference(q, k, v)}
            del s
            record = {"bhtd": [bh, t, d], "seed": seed}
            for name, got in outs.items():
                record[name] = {
                    f"vs_{r}": float(((got.double() - ref).abs() / (
                        2e-3 + 2.0 ** -7 * ref.abs())).max())
                    for r, ref in refs.items() if r != name}
            record["this_vs_other_max_abs"] = float(
                (outs["this"].float() - other.float()).abs().max())
            yield record


def f64_record(shape=(48, 1024, 128), perturbations: int = 8) -> dict:
    """dk of B3 at ``shape`` from the inputs :func:`main` draws there
    (generator seed 4: every shape's forward q, k, v, then each earlier
    shape's backward q, k, v, dO), against references that all round dS
    through bf16 before the product with Q, as the kernel does, but differ
    in how dS is computed before that rounding:

    * ``twin32``: ``flash_bwd_dkv_plain`` (f32, P = exp(S / sqrt(D) - lse));
    * ``twin64``: the same formula in f64 on the same o, lse and Delta;
    * ``twin32_exp2``: the kernel's own formula in f32, P = exp2(S * scale
      log2 e - lse log2 e) on unscaled scores, the product with Q in f64;
    * ``perturbed``: ``twin32_exp2`` with P and dP each moved by a random
      whole number of f32 ulps an element, at most 1, 4 or 16
      (``ULP_MOVES``), ``perturbations`` draws each: the size of the
      differences the kernel's own accumulation order and ``ex2.approx``
      make;

    and ``exact64``, f64 throughout from q, k, v and dO, nothing rounded.
    Each error is over the card tolerance (atol 2e-3 + rtol 2^-7 of the
    reference), with the values at the element where the kernel and the
    f32 twin differ most over it.  If moves of P and dP by a few ulps
    shift that element by about as much as the kernel differs from the
    twins, the difference is the bf16 rounding of dS flipping, not a
    fault in the kernel's arithmetic."""
    import math

    from trustworthy_dl_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)

    def draw(n, bh, t, d):
        return [torch.randn(bh, t, d, device=dev, generator=gen).to(
            torch.bfloat16) for _ in range(n)]

    for dims in SHAPES:
        draw(3, *dims)
    for dims in SHAPES[:SHAPES.index(tuple(shape))]:
        draw(4, *dims)
    q, k, v, do = draw(4, *shape)
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(dim=-1)
    kernel = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)[0].float()
    twin32 = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta)[0].float()
    t, d = shape[1], shape[2]
    scale = 1.0 / math.sqrt(d)
    q64, k64, v64, do64 = (a.double() for a in (q, k, v, do))
    mask = torch.ones(t, t, dtype=torch.bool, device=dev).tril()

    def dk_of(ds, rounded):
        """scale * dS^T . Q in f64, dS rounded through bf16 first or not."""
        if rounded:
            ds = ds.to(torch.bfloat16)
        return torch.einsum("bts,btd->bsd", ds.double(), q64) * scale

    s = torch.einsum("btd,bsd->bts", q64, k64) * scale
    s = torch.where(mask, s, torch.full_like(s, -math.inf))
    dp = torch.einsum("btd,bsd->bts", do64, v64)
    p = torch.exp(s - lse.double()[..., None])
    twin64 = dk_of(p * (dp - delta.double()[..., None]), True)
    lse64 = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse64[..., None])
    o64 = torch.einsum("bts,bsd->btd", p, v64)
    exact64 = dk_of(p * (dp - (do64 * o64).sum(dim=-1)[..., None]), False)
    del s, dp, p

    # The kernel's formula in f32 (TF32 off: products of bf16 values are
    # exact in f32, as in the kernel's mma).
    log2e = 1.4426950408889634
    s32 = torch.einsum("btd,bsd->bts", q.float(), k.float())
    s32 = torch.where(mask, s32, torch.full_like(s32, -math.inf))
    p32 = torch.exp2(s32 * (scale * log2e) - (lse * log2e)[..., None])
    del s32
    dp32 = torch.einsum("btd,bsd->bts", do.float(), v.float())
    twin32_exp2 = dk_of(p32 * (dp32 - delta[..., None]), True)

    def over(got, ref):
        ref = ref.double()
        return (got.double() - ref).abs() / (2e-3 + 2.0 ** -7 * ref.abs())

    worst = over(kernel, twin32)
    idx = np.unravel_index(int(worst.argmax()), worst.shape)
    record = {"bhtd": list(shape), "element": [int(i) for i in idx]}
    for name, got, ref in (("kernel_vs_twin32", kernel, twin32),
                           ("kernel_vs_twin64", kernel, twin64),
                           ("twin32_vs_twin64", twin32, twin64),
                           ("kernel_vs_twin32_exp2", kernel, twin32_exp2),
                           ("twin32_exp2_vs_twin64", twin32_exp2, twin64),
                           ("kernel_vs_exact64", kernel, exact64),
                           ("twin32_vs_exact64", twin32, exact64),
                           ("twin64_vs_exact64", twin64, exact64)):
        record[f"{name}_over_tolerance"] = float(over(got, ref).max())
    at_element = {name: float(x[idx]) for name, x in (
        ("kernel", kernel), ("twin32", twin32), ("twin64", twin64),
        ("twin32_exp2", twin32_exp2), ("exact64", exact64))}

    # Moves of P and dP by up to 1, 4 or 16 f32 ulps: how far they carry
    # the element, and the whole dk, from twin64.
    pgen = torch.Generator(device=dev).manual_seed(5)
    moved, moved_any = {}, {}
    for ulps in ULP_MOVES:
        def nudge(x):
            u = torch.randint(-ulps, ulps + 1, x.shape, device=dev,
                              generator=pgen)
            return x * (1.0 + 2.0 ** -23 * u.float())
        for _ in range(perturbations):
            dk = dk_of(nudge(p32) * (nudge(dp32) - delta[..., None]), True)
            moved.setdefault(ulps, []).append(
                float(over(dk[idx], twin64[idx])))
            moved_any.setdefault(ulps, []).append(
                float(over(dk, twin64).max()))
    record["values_at_element"] = at_element
    record["kernel_vs_twin64_at_element"] = float(
        over(kernel[idx], twin64[idx]))
    record["perturbed_vs_twin64_at_element"] = moved
    record["perturbed_vs_twin64_over_tolerance"] = moved_any
    return record


if __name__ == "__main__":
    sys.exit(main())
