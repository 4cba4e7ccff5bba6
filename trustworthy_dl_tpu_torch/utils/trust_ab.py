"""This checkout's trust epilogue (B7) and fused verify tail (B8) against
another build of them, in one process on one card.

    python -m trustworthy_dl_tpu_torch.utils.trust_ab OTHER.cu [--reps 25]

``OTHER.cu`` is another version of ``ops/csrc/paged_attention.cu`` (the
parent commit's, from ``git show <commit>:<path>``, or an edited copy of
this one): it is built with the checkout's ``nvcc`` flags into a library
of its own, and both builds' ``tddl_trust_stats`` and ``tddl_verify_tail``
are called the same way, straight through the C entry (B8's scratch is
sized for both: [B, ceil(V / 128), 5] f32, which holds this build's
float4 partials and the arrival word after them).  Cases (seed 6, on the
card):

* B7 (:data:`TRUST_CASES`): f32 logits, normals times 2 with row 0's
  maximum duplicated, at the serve path's decode tick [8, 50257], a
  prompt's last chunk [1, 50257], 4 and 16 rows, and [5, 700] (odd V:
  every other row starts off a 16-byte boundary);
* B8 (:data:`VERIFY_CASES`): bf16 normed (normals) x a tied head (normals
  times 0.02, its last row a copy of row 7, the last normed row 60 times
  head row 7, so that row's maximum is duplicated), at the smoke's spec
  verify [40, 768] x 50257, 8 and 96 rows, and n_embd 96's [40, 96].

Both builds are held against the plain twins: B7's margin bit-equal to
``logit_trust_stats_plain``'s, B8's equal to top-2 of the build's own
logits and its logits within one bf16 step of ``fused_verify_tail_plain``'s
plus 1e-5 of sum |x| |w| (``chip_smoke.py``'s bounds), entropies within
:data:`ENTROPY_ATOL`.  Then each case is timed in turns (this, other,
other, this) with the L2 flushed, CUDA events and the profiler's device
time (every device operation of a call, ``device_ops``: this build's
B8 is a memset of its arrival word and one kernel, the parent's two
kernels), beside the library call (``logsumexp`` and ``topk``, after the
bf16 product for B8) (``utils/kernel_ab``).  Host microseconds to
enqueue one call are taken for this checkout's wrapper
(``wrapper_host_us``: the checks, the outputs' allocation and the launch)
and for each build's C entry.  Prints one JSON line per case, with the
least time the card could take for it (``bound_ms``), then the card's
name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

#: Entropy within this of the plain twin's (one f32 pass over up to 50257
#: terms against log_softmax's two), as ``chip_smoke.py``.
ENTROPY_ATOL = 1e-4
#: B8's logits: one bf16 step of the twin's plus this times sum |x| |w|.
LOGITS_RTOL = 1e-5
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
#: (label, B, V).
TRUST_CASES = (
    ("decode", 8, 50257),
    ("prefill_tail", 1, 50257),
    ("rows4", 4, 50257),
    ("rows16", 16, 50257),
    ("odd_v", 5, 700),
)
#: (label, B, D, V).
VERIFY_CASES = (
    ("smoke", 40, 768, 50257),
    ("rows8", 8, 768, 50257),
    ("rows96", 96, 768, 50257),
    ("d96", 40, 96, 50257),
)


def trust_bound_ms(b: int, v: int) -> float:
    """Least time for B7: the f32 logits read once and entropy and margin
    written once at the memory rate, or 6 f32 operations a logit at the
    f32 rate, whichever is longer (``chip_smoke.py``'s count)."""
    return max((b * v * 4 + 2 * b * 4) / HBM_BYTES_PER_S,
               6 * b * v / PEAK_FLOPS["float32"]) * 1e3


def verify_bound_ms(b: int, d: int, v: int) -> float:
    """Least time for B8: the bf16 head and normed read once, the f32
    logits, entropy and margin written once, or 2 B D V flops at the bf16
    tensor rate, whichever is longer."""
    n_bytes = v * d * 2 + b * d * 2 + b * v * 4 + 2 * b * 4
    return max(n_bytes / HBM_BYTES_PER_S,
               2 * b * d * v / PEAK_FLOPS["bfloat16"]) * 1e3


def library_trust(logits: torch.Tensor):
    """The yardstick: ``logsumexp`` and top-2, the two library calls that
    give logZ and the margin (the entropy has no single library call)."""
    return torch.logsumexp(logits, -1), torch.topk(logits, 2, -1)


def library_verify(normed: torch.Tensor, head_t: torch.Tensor):
    """B8's yardstick: the bf16 product upcast after it, then
    :func:`library_trust`'s two calls."""
    return library_trust((normed @ head_t).float())


def trust_inputs(b: int, v: int, gen, dev) -> torch.Tensor:
    logits = torch.randn(b, v, device=dev, generator=gen) * 2.0
    logits[0, 11 % v] = logits[0, 4000 % v] = float(logits[0].max()) + 1.0
    return logits


def verify_inputs(b: int, d: int, v: int, gen, dev):
    head = (torch.randn(v, d, device=dev, generator=gen) * 0.02).to(
        torch.bfloat16)
    head[v - 1] = head[7]
    normed = torch.randn(b, d, device=dev, generator=gen).to(torch.bfloat16)
    normed[b - 1] = (head[7].float() * 60.0).to(torch.bfloat16)
    return normed, head


def trust_check(got, logits) -> dict:
    """Margin bit-equal to the plain twin's, entropy within tolerance."""
    from trustworthy_dl_tpu_torch.ops import paged_attention as pa

    ent, mar = got
    ent_ref, mar_ref = pa.logit_trust_stats_plain(logits)
    ent_err = float((ent - ent_ref).abs().max())
    return {"within_tolerance": bool(torch.equal(mar, mar_ref)
                                     and ent_err <= ENTROPY_ATOL),
            "entropy_max_abs_err": ent_err}


def verify_check(got, normed, head) -> dict:
    """Logits within the bound of the twin's, margin equal to top-2 of the
    build's own logits, entropy within tolerance."""
    from trustworthy_dl_tpu_torch.ops import paged_attention as pa

    logits, ent, mar = got
    ref, ent_ref, _ = pa.fused_verify_tail_plain(normed, head)
    bound = ref.abs() * 2.0 ** -7 \
        + LOGITS_RTOL * (normed.float().abs() @ head.float().abs().T)
    excess = float(((logits - ref).abs() - bound).max())
    top2 = torch.topk(logits, 2, dim=-1).values
    ent_err = float((ent - ent_ref).abs().max())
    return {"within_tolerance": bool(
                excess <= 0.0 and torch.equal(mar, top2[:, 0] - top2[:, 1])
                and ent_err <= ENTROPY_ATOL),
            "logits_excess_over_bound": excess,
            "max_abs_err": float((logits - ref).abs().max()),
            "entropy_max_abs_err": ent_err}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="another paged_attention.cu")
    parser.add_argument("--reps", type=int, default=25)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("trust_ab: needs a CUDA card", file=sys.stderr)
        return 1
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.ops import paged_attention as pa
    from trustworthy_dl_tpu_torch.utils import kernel_ab as ab

    libs = {"this": ops.kernel_library("paged_attention"),
            "other": ab.other_library(args.other, "paged_attention")}
    dev = torch.device("cuda")
    flush = ab.flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(6)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def trust_entry(lib, logits):
        b, v = logits.shape
        ent = torch.empty(b, dtype=torch.float32, device=dev)
        mar = torch.empty_like(ent)
        err = lib.tddl_trust_stats(logits.data_ptr(), ent.data_ptr(),
                                   mar.data_ptr(), b, v, stream())
        ops.check_launch(lib, err, "tddl_trust_stats")
        return ent, mar

    def verify_entry(lib, normed, head, scratch):
        b, d = normed.shape
        v = head.shape[0]
        logits = torch.empty(b, v, dtype=torch.float32, device=dev)
        ent = torch.empty(b, dtype=torch.float32, device=dev)
        mar = torch.empty_like(ent)
        err = lib.tddl_verify_tail(
            normed.data_ptr(), head.data_ptr(), logits.data_ptr(),
            scratch.data_ptr(), ent.data_ptr(), mar.data_ptr(), b, d, v,
            stream())
        ops.check_launch(lib, err, "tddl_verify_tail")
        return logits, ent, mar

    def run(record, arms, library, check, wrapper):
        for name, arm in arms.items():
            got = arm()
            torch.cuda.synchronize()
            record.update({f"{name}_{k}": val
                           for k, val in check(got).items()})
        record["wrapper_host_us"] = ab.host_us(wrapper)
        for name, arm in arms.items():
            record[f"{name}_host_us"] = ab.host_us(arm)
        # Each build's device operations a call, by name: all are timed.
        record["device_ops"] = {name: ab.kernel_names(arm, flush)
                                for name, arm in arms.items()}
        launches = {name: len(names)
                    for name, names in record["device_ops"].items()}
        arms["library"] = library
        record.update(ab.in_turns(
            arms, ("this", "other", "other", "this", "library"), flush,
            args.reps, launches=launches))
        for name in ("other", "library"):
            record[f"{name}_over_this_device"] = (
                min(record[f"{name}_device_ms"]) /
                min(record["this_device_ms"]))
        print(json.dumps(record), flush=True)

    for label, b, v in TRUST_CASES:
        logits = trust_inputs(b, v, gen, dev)
        record = {"kernel": "B7", "case": label, "logits": [b, v],
                  "bound_ms": trust_bound_ms(b, v)}
        arms = {name: (lambda lib=lib: trust_entry(lib, logits))
                for name, lib in libs.items()}
        run(record, arms, lambda: library_trust(logits),
            lambda got: trust_check(got, logits),
            lambda: pa.logit_trust_stats(logits))

    for label, b, d, v in VERIFY_CASES:
        normed, head = verify_inputs(b, d, v, gen, dev)
        head_t = head.T
        scratch = torch.empty(b, -(-v // pa.VERIFY_TILE_COLS), 5,
                              dtype=torch.float32, device=dev)
        record = {"kernel": "B8", "case": label, "normed": [b, d],
                  "head": [v, d], "bound_ms": verify_bound_ms(b, d, v)}
        arms = {name: (lambda lib=lib: verify_entry(lib, normed, head,
                                                    scratch))
                for name, lib in libs.items()}
        run(record, arms, lambda: library_verify(normed, head_t),
            lambda got: verify_check(got, normed, head),
            lambda: pa.fused_verify_tail(normed, head))
    print(ab.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
