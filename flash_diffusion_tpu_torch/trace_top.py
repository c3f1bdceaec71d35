"""Rank the device kernels of a ``torch.profiler`` chrome trace by total time.

    python -m flash_diffusion_tpu_torch.trace_top --parse trace.json [--top 30]
    python -m flash_diffusion_tpu_torch.trace_top --model sdxl --batch 4 [--int8] [--decode] [--out dir]
        [--top 30]

Port of ``tools/trace_top.py``. ``--parse`` reads a trace that
``utils.profiling.profile``, the server's ``POST /profile`` (its
``trace.json``) or ``profiling.py --trace`` wrote. Without it, the tool
builds the pipeline as ``sample.build_pipeline(model)`` does (random bf16
weights; ``--int8``: ``FlashPipeline.quantize("int8")``), runs one
``generate`` of ``--batch`` prompts on the card to warm up, then one more
under ``profile`` (``--decode``: the VAE decode of a batch of latents
alone), and ranks that trace.

Kernel names collapse to the function's name: template arguments, the
argument list, ``void`` and a numeric launch suffix go, so that repeated
layers add up; each row carries the TPU kernel the port's kernel replaces
(``utils.profiling.kernel_id``: K1–K12, "K9 fused" the resident GroupNorm,
"GN apply" its apply pass), told apart before the names collapse. The rows
past ``--top`` print as one line. Then each ``fdt.*`` stage span's device
time: the kernels that start between its device-side start and the next
span's (the last one's to its own end), as ``profiling.py`` counts them. A
trace without device activity (profiled on the CPU) ranks its host ops
instead, each by its own time (less its children's).
"""

from __future__ import annotations

import argparse
import json
import re
import tempfile
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

from .utils.profiling import kernel_id

# chrome-trace categories of device activity; the record_function spans'
# device-side copies are "gpu_user_annotation"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Row(NamedTuple):
    name: str  # the collapsed kernel name
    kernel: Optional[str]  # its K-tag, or None
    count: int
    ms: float
    share: float  # of the trace's device time


class Ranking(NamedTuple):
    total_ms: float
    rows: List[Row]  # every kernel, by total time
    stages: Dict[str, Tuple[float, int, float]]  # span → (busy ms, kernels, span ms)
    on: str  # "device", or "host" for a trace without device activity


def _strip_brackets(name: str, open_: str, close: str) -> str:
    out, depth = [], 0
    for ch in name:
        if ch == open_:
            depth += 1
        elif ch == close and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    return "".join(out)


def collapse(name: str) -> str:
    """``void ns::(anonymous namespace)::kernel<4, float>(int, float*)
    [clone .kd]`` and ``kernel_123`` alike to ``ns::kernel`` and ``kernel``:
    an anonymous namespace, template arguments, the argument list, a clone
    note, ``void`` and a numeric suffix dropped."""
    short = name.replace("(anonymous namespace)::", "")
    short = _strip_brackets(_strip_brackets(short, "<", ">"), "(", ")")
    short = re.sub(r"\[clone [^\]]*\]", "", short)
    short = re.sub(r"^\s*void\s+", "", short).strip()
    return re.sub(r"(?:[._]\d+)+$", "", short) or name


def _host_self_times(ops: List[dict]) -> List[Tuple[dict, float]]:
    """Each host op with its own time (its duration less its children's on
    the same thread), so that nested ops are not counted twice."""
    out = []
    for tid in {(e.get("pid"), e.get("tid")) for e in ops}:
        stack = []  # [event, end, children's µs]
        for e in sorted((e for e in ops if (e.get("pid"), e.get("tid")) == tid),
                        key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0)))):
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            while stack and ts >= stack[-1][1]:
                done = stack.pop()
                out.append((done[0], float(done[0].get("dur", 0.0)) - done[2]))
            if stack:
                stack[-1][2] += dur
            stack.append([e, ts + dur, 0.0])
        out += [(done[0], float(done[0].get("dur", 0.0)) - done[2]) for done in stack]
    return out


def rank(events: List[dict]) -> Ranking:
    """The ranking of a chrome trace's ``traceEvents``: its device kernels,
    copies and fills; in a trace without any (the CPU alone), its host ops
    by their own time."""
    complete = [e for e in events if e.get("ph") == "X" and "ts" in e]
    device = [e for e in complete if e.get("cat") in DEVICE_CATEGORIES]
    on = "device" if device else "host"
    if device:
        timed = [(e, float(e.get("dur", 0.0))) for e in device]
    else:
        timed = _host_self_times([e for e in complete if e.get("cat") == "cpu_op"])
    tot, cnt = defaultdict(float), defaultdict(int)
    for e, us in timed:
        key = (collapse(e["name"]), kernel_id(e["name"]) if e.get("cat") == "kernel" else None)
        tot[key] += us / 1e3
        cnt[key] += 1
    total = sum(tot.values())
    rows = [Row(name, kid, cnt[(name, kid)], ms, ms / total if total else 0.0)
            for (name, kid), ms in sorted(tot.items(), key=lambda kv: -kv[1])]
    span_cat = "gpu_user_annotation" if device else "user_annotation"
    spans = sorted((e for e in complete if e.get("cat") == span_cat and e.get("name", "").startswith("fdt.")),
                   key=lambda e: float(e["ts"]))
    starts = [(float(e["ts"]), us) for e, us in timed]
    stages = {}
    for span, nxt in zip(spans, spans[1:] + [None]):
        lo = float(span["ts"])
        hi = float(nxt["ts"]) if nxt else lo + float(span.get("dur", 0.0))
        inside = [us for ts, us in starts if lo <= ts < hi]
        name = span["name"] if span["name"] not in stages else f"{span['name']} ({len(stages)})"
        stages[name] = (sum(inside) / 1e3, len(inside), (hi - lo) / 1e3)
    return Ranking(total, rows, stages, on)


def parse_trace(path: str, top: int = 30) -> Ranking:
    """Rank the trace at ``path`` and print the ranking: the top ``top``
    rows, the long tail as one line, then the stages."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    ranking = rank(events)
    if not ranking.rows:
        raise SystemExit(f"no device kernels and no host ops in {path}")
    what = "device time" if ranking.on == "device" else "host time of the ops (no device activity in the trace)"
    print(f"TOTAL {what} {ranking.total_ms:.3f} ms ({sum(r.count for r in ranking.rows)} "
          f"{'launches' if ranking.on == 'device' else 'ops'})")
    for r in ranking.rows[:top]:
        print(f"{r.ms:10.3f} ms  {100 * r.share:5.1f}%  n={r.count:5d}  {r.kernel or '-':8s} {r.name[:110]}")
    rest = ranking.rows[top:]
    if rest:
        ms = sum(r.ms for r in rest)
        print(f"{ms:10.3f} ms  {100 * ms / ranking.total_ms:5.1f}%  n={sum(r.count for r in rest):5d}  "
              f"(long tail: {len(rest)} {'kernels' if ranking.on == 'device' else 'ops'})")
    for name, (ms, n, span) in ranking.stages.items():
        print(f"  stage {name:21s} {ranking.on} busy {ms:9.3f} ms of a {span:9.3f} ms span, {n} "
              f"{'kernels' if ranking.on == 'device' else 'ops'}")
    if not ranking.stages:
        print(f"  no fdt.* stage spans on the {ranking.on} in this trace")
    return ranking


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parse", default=None, help="rank an existing chrome trace and exit")
    ap.add_argument("--model", default="sdxl", choices=["sd15", "sdxl", "pixart", "sd3"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--int8", action="store_true", help="the W8A8 int8 mode")
    ap.add_argument("--decode", action="store_true", help="the VAE decode of a batch of latents alone")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--out", default=None, help="the trace's directory (default: a temporary one)")
    args = ap.parse_args()
    if args.parse:
        parse_trace(args.parse, args.top)
        return

    import torch

    from .sample import build_pipeline
    from .utils.profiling import profile

    if not torch.cuda.is_available():
        raise SystemExit("trace_top: CUDA is not available")
    pipe = build_pipeline(args.model, device="cuda")
    if args.int8:
        pipe.quantize("int8")
    prompts = (["a photograph of an astronaut riding a horse"] * args.batch)[:args.batch]
    if args.decode:
        z = torch.randn(args.batch, *pipe.latent_shape, generator=torch.Generator("cuda").manual_seed(0),
                        device="cuda")
        run = lambda: pipe.vae.decode_latents(z)
    else:
        run = lambda: pipe.generate(prompts)
    with torch.inference_mode():
        run()
        torch.cuda.synchronize()
        with profile(args.out or tempfile.mkdtemp(prefix="trace_top_")) as path:
            run()
            torch.cuda.synchronize()
    print(f"trace: {path}")
    parse_trace(path, args.top)


if __name__ == "__main__":
    main()
