"""This checkout's detector moment battery (B1) against another build of
it, in one process on one card.

    python -m trustworthy_dl_tpu_torch.utils.moments_ab [OTHER_ROOT]
        [--variant DIAG=N] ... [--mixes gpt2,...] [--reps 10]

``OTHER_ROOT`` is the root of another checkout (the parent commit's,
from a ``git archive`` under ``build/``).  Its
``ops/csrc/fused_stats.cu`` is built with the checkout's ``nvcc`` flags
into a library of its own, and its own wrapper, ``ops/fused_stats.py``,
is loaded beside this one and launches that library, split at its own
``MAX_SEGMENTS`` as ``engine.step._moments`` splits
(:func:`other_battery`): each build is timed with the host work of its
own wrapper.  Each ``--variant DIAG=N`` is the checkout's source built
with ``-DTDDL_B1_DIAG=N`` (1: loads only, 2: loads and sum x; see the
note in the source) and launched through ``ops.fused_stats``'
``launch_moments``; they compute no battery, so their results are not
checked.

Mixes (:data:`MIXES`; random gradients, normals times 1e-3, seed 2, of
each drive's leaf shapes on every node, split as ``engine.step._moments``
splits them):

* ``gpt2``: GPT-2 small's 16 leaves on 4 nodes (64 segments, 497.8 M
  values), the ``train`` drive's battery;
* ``resnet101``: ResNet-101's 418 leaves on 8 nodes (3,344 segments), the
  ``vision`` drive's (``resnet101_large``: only its segments of at least
  one chunk, 32,768 values, to see what the short ones cost);
* ``pipeline``: the 12 stacked block leaves of GPT-2 small on each of 4
  stages (48 segments, 85.1 M values), the ``pipeline`` drive's;
* ``moe``: ``gpt2-moe``'s 17 leaves on 4 nodes (68 segments, 2.08e9
  values), the ``moe`` drive's.

Each mix prints one JSON line: every build's rows against the plain twin
(the sums within :data:`MOMENT_RTOL` of each segment's magnitude sums,
min, max and max |x| exact), whether two eager calls of this build and a
replay of one captured in a CUDA graph give the same bits, the least
time the card could take (``bound_ms``), then in turns (this, other,
other, this; L2 flushed before each call): ``*_ms`` (CUDA events, which
hold the wrapper's host work whenever the card waits for it),
``*_device_ms`` (the profiler's time of every device operation of a
battery: kernels and the ticket memset) and ``*_graph_ms`` (the battery
replayed as one CUDA graph), and each build's host microseconds to
enqueue one battery.  A last line per other build gives host us a call
and a segment at 124 and 1,024 of ResNet-101's segments.  Then the
card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Sequence, Tuple

import torch

#: Each sum within this of its magnitude sum, as ``chip_smoke.py``.
MOMENT_RTOL = 1e-5
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_F32_FLOPS = 67e12
#: (mix, model, nodes): every leaf of ``model`` on each of ``nodes``;
#: ``pipeline`` stacks GPT-2 small's blocks into that many stages.
MIXES = (("gpt2", "gpt2", 4), ("resnet101", "resnet101", 8),
         ("resnet101_large", "resnet101", 8), ("pipeline", "gpt2", 4),
         ("moe", "gpt2-moe", 4))
#: The mixes run unless ``--mixes`` names others.
DEFAULT_MIXES = ("gpt2", "resnet101", "pipeline", "moe")
#: Segment counts at which host us a call are taken.
HOST_COUNTS = (124, 1024)


def bound_ms(segments: Sequence[torch.Tensor]) -> Tuple[float, str]:
    """Least time for the battery: each value read once and the rows
    written once at the memory rate, or 12 f32 operations a value at the
    f32 rate (``chip_smoke.py``'s count), whichever is longer."""
    n_el = sum(x.numel() for x in segments)
    t_bytes = (n_el * 4 + len(segments) * 32) / HBM_BYTES_PER_S * 1e3
    t_ops = n_el * 12 / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def parse_variant(spec: str) -> int:
    """``"DIAG=1"`` -> 1, the ``TDDL_B1_DIAG`` of a diagnostic build."""
    key, _, value = spec.partition("=")
    if key.strip().upper() != "DIAG" or not value.strip().isdigit():
        raise ValueError(f"moments_ab: a variant is DIAG=<n>, got {spec!r}")
    return int(value)


def split(call: Callable, segments: Sequence[torch.Tensor], cap: int
          ) -> torch.Tensor:
    """``call`` over ``cap`` segments at a time, as ``_moments`` splits."""
    if len(segments) <= cap:
        return call(segments)
    return torch.cat([call(segments[i:i + cap])
                      for i in range(0, len(segments), cap)])


def other_wrapper(root: Path, lib) -> ModuleType:
    """``root``'s ``ops/fused_stats.py``, loaded as a module of its own
    whose ``kernel_library`` returns ``lib`` (its build of the kernel); it
    imports the rest of ``ops`` from this checkout."""
    path = root / "trustworthy_dl_tpu_torch" / "ops" / "fused_stats.py"
    spec = importlib.util.spec_from_file_location("moments_ab_other", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.kernel_library = lambda name: lib
    return module


def other_battery(root: Path) -> Tuple[Callable, int]:
    """``root``'s battery (its kernel through its own wrapper, split at its
    own cap) and the segments one of its calls takes."""
    from trustworthy_dl_tpu_torch.utils import kernel_ab as ab

    lib = ab.other_library(root / "trustworthy_dl_tpu_torch" / "ops"
                           / "csrc" / "fused_stats.cu", "fused_stats")
    module = other_wrapper(root, lib)
    cap = module.MAX_SEGMENTS
    return (lambda segs: split(module.fused_moments, segs, cap)), cap


def mix_segments(mix: str, model: str, nodes: int, device: torch.device
                 ) -> List[torch.Tensor]:
    """A mix's gradient segments: normals times 1e-3 (seed 2) of every
    leaf of ``model`` on each node (or stage), node-major, as the drive's
    step lists them."""
    from trustworthy_dl_tpu_torch.models.factory import create_model
    from trustworthy_dl_tpu_torch.parallel.pipeline import stack_stages
    from trustworthy_dl_tpu_torch.utils.tree import tree_leaves

    gen = torch.Generator(device=device).manual_seed(2)
    params = create_model(model).init(gen, device)
    if mix == "resnet101_large":
        params = [x for x in tree_leaves(params) if x.numel() >= 32768]
    if mix == "pipeline":
        shapes = [tuple(x.shape[1:]) for x in tree_leaves(
            stack_stages(params["blocks"], nodes))]
    else:
        shapes = [tuple(x.shape) for x in tree_leaves(params)]
    del params
    grads = [torch.randn((nodes,) + s, device=device, generator=gen) * 1e-3
             for s in shapes]
    return [g[i].reshape(-1) for i in range(nodes) for g in grads]


def twin_check(got: torch.Tensor, segments: Sequence[torch.Tensor]
               ) -> Dict[str, object]:
    """A build's rows against the plain twin."""
    from trustworthy_dl_tpu_torch.ops import fused_stats as fs

    ref = fs.fused_moments_plain(segments)
    sums = [fs.S1, fs.S2, fs.S3, fs.S4, fs.L1]
    mag = torch.stack([torch.stack([x.abs().sum(), (x * x).sum(),
                                    (x.abs() ** 3).sum(), (x ** 4).sum(),
                                    x.abs().sum()]) for x in segments])
    err = (got[:, sums] - ref[:, sums]).abs()
    exact = [fs.MIN, fs.MAX, fs.LINF]
    return {"max_abs_err": float(err.max()),
            "worst_err_over_magnitude": float((err / mag).max()),
            "extrema_exact": torch.equal(got[:, exact], ref[:, exact]),
            "within_tolerance": bool((err <= MOMENT_RTOL * mag).all())
            and torch.equal(got[:, exact], ref[:, exact])}


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def graph_bits_equal(fn: Callable[[], torch.Tensor],
                     eager: torch.Tensor) -> bool:
    """Whether two replays of ``fn`` captured as one CUDA graph give
    ``eager``'s bits."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = fn()
    same = True
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        same = same and torch.equal(bits(out), bits(eager))
    del graph
    return same


def in_turns(arms: Dict[str, Callable], flush: torch.Tensor, reps: int
             ) -> Dict[str, list]:
    """``{arm}_ms``, ``{arm}_device_ms`` and ``{arm}_graph_ms``, one entry
    a turn of this, other, other, this (``utils/kernel_ab``).  A device
    time the profiler could not take whole (it has dropped launch records
    of long batteries) is recorded as None, with the reason."""
    from trustworthy_dl_tpu_torch.utils import kernel_ab as ab

    record: Dict[str, list] = {}
    for arm in ("this", "other", "other", "this"):
        fn = arms[arm]
        record.setdefault(f"{arm}_ms", []).append(
            ab.event_ms(fn, flush, reps))
        try:
            dev_ms = ab.device_ms(fn, flush, reps)
        except RuntimeError as err:
            dev_ms = None
            record.setdefault(f"{arm}_device_error", []).append(str(err))
        record.setdefault(f"{arm}_device_ms", []).append(dev_ms)
        record.setdefault(f"{arm}_graph_ms", []).append(
            ab.graph_ms(fn, flush, reps))
    return record


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, nargs="?",
                        help="the root of another checkout")
    parser.add_argument("--variant", action="append", default=[],
                        help="DIAG=<n>: the checkout's source built with "
                             "TDDL_B1_DIAG=<n>")
    parser.add_argument("--mixes", default=",".join(DEFAULT_MIXES))
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("moments_ab: needs a CUDA card", file=sys.stderr)
        return 1
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.engine.step import _moments
    from trustworthy_dl_tpu_torch.ops import fused_stats as fs
    from trustworthy_dl_tpu_torch.utils import kernel_ab as ab

    dev = torch.device("cuda")
    flush = ab.flush_buffer(dev)
    this_lib = ops.kernel_library("fused_stats")
    # name -> (call of one battery over a segment list, whether checked,
    # the segments one call takes).
    others: Dict[str, Tuple[Callable, bool, int]] = {}
    if args.other is not None:
        call, cap = other_battery(args.other)
        others["other"] = (call, True, cap)
    for spec in args.variant:
        diag = parse_variant(spec)
        lib = ab.other_library(ops.CSRC / "fused_stats.cu", "fused_stats",
                               [f"TDDL_B1_DIAG={diag}"])
        others[f"variant {spec}"] = (
            lambda segs, lib=lib: split(
                lambda part: fs.launch_moments(lib, part), segs,
                fs.MAX_SEGMENTS),
            diag == 0, fs.MAX_SEGMENTS)
    if not others:
        parser.error("give another source or at least one --variant")

    wanted = args.mixes.split(",")
    host_segs: List[torch.Tensor] = []
    for mix, model, nodes in MIXES:
        if mix not in wanted:
            continue
        segs = mix_segments(mix, model, nodes, dev)
        b_ms, b_by = bound_ms(segs)
        record = {"mix": mix, "segments": len(segs),
                  "elements": sum(x.numel() for x in segs),
                  "bound_ms": b_ms, "bound_by": b_by,
                  "this_launches_per_battery": -(-len(segs)
                                                 // fs.MAX_SEGMENTS)}
        this = _moments(segs)
        torch.cuda.synchronize()
        record["this_check"] = twin_check(this, segs)
        again = _moments(segs)
        torch.cuda.synchronize()
        record["this_repeat_bit_equal"] = torch.equal(bits(this),
                                                      bits(again))
        record["this_graph_bit_equal"] = graph_bits_equal(
            lambda: _moments(segs), this)
        record["this_host_us"] = ab.host_us(lambda: _moments(segs),
                                            calls=20)
        for name, (call, checked, cap) in others.items():
            got = call(segs)
            torch.cuda.synchronize()
            entry = {"launches_per_battery": -(-len(segs) // cap),
                     "vs_this_max_abs": float((got - this).abs().max())}
            if checked:
                entry["check"] = twin_check(got, segs)
            entry["host_us"] = ab.host_us(lambda: call(segs), calls=20)
            arms = {"this": lambda: _moments(segs),
                    "other": lambda call=call: call(segs)}
            entry.update(in_turns(arms, flush, args.reps))
            record[name] = entry
        print(json.dumps(record), flush=True)
        if mix == "resnet101":
            host_segs = segs[:max(HOST_COUNTS)]
        del segs, this, again
        torch.cuda.empty_cache()

    if host_segs:
        for name, (call, _, cap) in others.items():
            record = {"host": name}
            for count in HOST_COUNTS:
                segs = host_segs[:count]
                arms = {"this": lambda: _moments(segs),
                        "other": lambda: call(segs)}
                for arm in ("this", "other", "other", "this"):
                    us = ab.host_us(arms[arm], calls=100)
                    record.setdefault(f"{arm}_us_{count}", []).append(us)
                    record.setdefault(f"{arm}_us_per_segment_{count}",
                                      []).append(us / count)
                record[f"other_calls_{count}"] = -(-count // cap)
            print(json.dumps(record), flush=True)
    print(ab.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
