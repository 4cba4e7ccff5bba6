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
of the kernel (``device_ms``), beside SDPA's on the same inputs.  One
JSON line per shape.

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
which backend torch picked).  Then the card's name and power limit.
About a minute for both passes, the other build's nvcc included.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

SHAPES = ((96, 1024, 64), (96, 1024, 32), (48, 1024, 128))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="another flash_attention.cu")
    parser.add_argument("--reps", type=int, default=25)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ab: needs a CUDA card", file=sys.stderr)
        return 1
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

    def other_dq(q, k, v, do, lse, delta):
        dq = torch.empty_like(q)
        other_call("tddl_flash_bwd_dq", q, k, v, do, lse, delta, dq)
        return dq

    def other_dkv(q, k, v, do, lse, delta):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        other_call("tddl_flash_bwd_dkv", q, k, v, do, lse, delta, dk, dv)
        return dk, dv

    def worst(got, ref):
        """The largest error over its tolerance (at most 1 is within)."""
        err = (got.float() - ref.float()).abs()
        return float((err / (2e-3 + 2.0 ** -7 * ref.float().abs())).max())

    gen = torch.Generator(device=dev).manual_seed(4)
    for bh, t, d in SHAPES:
        q, k, v = (torch.randn(bh, t, d, device=dev, generator=gen).to(
            torch.bfloat16) for _ in range(3))
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v)
        arms = {"this": lambda: fa.flash_attention_fwd(q, k, v),
                "other": lambda: other_fwd(q, k, v)}
        record = {"bhtd": [bh, t, d]}
        for name, fn in arms.items():
            o, lse = fn()
            torch.cuda.synchronize()
            err = (o.float() - o_ref.float()).abs()
            record[f"{name}_within_tolerance"] = bool(
                (err <= 2e-3 + 2.0 ** -7 * o_ref.float().abs()).all()
                and float((lse - lse_ref).abs().max()) <= 1e-3)
        q4, k4, v4 = (a.view(1, bh, t, d) for a in (q, k, v))
        arms["sdpa"] = lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True)
        record.update(ab.in_turns(arms, ("this", "other", "other", "this",
                                         "sdpa"), flush, args.reps))
        flops = 2 * bh * d * (t * (t + 1) // 2) * 2
        record["this_device_tflops"] = flops / (
            min(record["this_device_ms"]) * 1e-3) / 1e12
        print(json.dumps(record), flush=True)
    for bh, t, d in SHAPES:
        print(json.dumps(backward_record(
            fa, ab, F, flush, args.reps, gen, bh, t, d, other_dq, other_dkv,
            worst)), flush=True)
    print(ab.card_line())
    return 0


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


if __name__ == "__main__":
    sys.exit(main())
