#!/usr/bin/env python3
"""Time the two scatter-adds, the weighted gather's d_feat backward (kernel
row 13) and the row gather's backward (row 15), of one or more checkouts of
the PyTorch port on one NVIDIA GPU, in turns.

    python3 scripts/torch_scatter_timing.py                # this checkout
    python3 scripts/torch_scatter_timing.py --roots OLD . . OLD [--designs]

Each root is a directory that holds ``adaptpoint_tpu_torch``; each runs in a
child process of its own, which builds that checkout's kernels and prints
one JSON line. Inputs are seeded and the same for every root, B = 32: a
unit-ball cloud of 2048 points, its FPS half and that half's prefixes (the
augmentor's levels), the 3-NN of each decode level from the kNN kernel and
its reciprocal-distance weights:

- row 13 (``weighted_gather3_bwd_cuda`` without ``d_w``, as the bf16
  GAN step calls it) at the decode's four levels, (N, M, C) = (2048, 1024,
  128), (1024, 512, 256), (512, 256, 512), (256, 128, 1024), on bf16
  features and an f32 cotangent; beside it the composite's backward
  (autograd of gather, multiply, sum: the port's f32 route);
- row 15 (``gather_rows_bwd_cuda``) at the f32 GAN step's five calls: the
  head pooling (the 24 nearest of 128 points to each of 4 anchors: 96 slots
  onto 128 rows, C = 1024) and the decode's four levels (3 N slots onto M
  rows); and at the train step's resampling shape, (32, 2048, 4) <-> 1024
  distinct rows; beside each ``index_add_`` of the same cotangent onto
  zeros (one PyTorch call computing the same function in f32).

For each call: the device time of a call alone (``torch.profiler``, every
kernel and memset of the call, with the device ops a call by name, from the
median of three profiles), the host's enqueue time a call, the mean of a
CUDA-event loop, the byte bound (inputs read once, outputs written once);
two launches compared bit for bit, and, where the checkout has the ordered
plain functions, the kernel against them bit for bit. Also the kernels'
registers and spills from the build. ``--designs`` also times every design
of ``ops.scatter_rows.DESIGNS`` that the checkout has at each shape, its
launch shape forced through ``choose``. The card's name and power limit
(``nvidia-smi``) lead the output; ``--out`` gets the same lines.

Compare two checkouts only inside one run: hosts and clocks differ between
machines. Needs a GPU; exits with 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 32
N_GAN = 2048
# the augmentor's decode levels: (N unknown points, M known, C channels)
LEVELS = [(2048, 1024, 128), (1024, 512, 256), (512, 256, 512),
          (256, 128, 1024)]
PEAK_BYTES = 3.35e12  # H100 SXM


def cuda_ms(fn, min_total_ms: float = 50.0) -> float:
    """Mean ms of ``fn()`` by CUDA events after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    one = max(start.elapsed_time(end), 1e-3)
    reps = int(min(200, max(5, min_total_ms / one)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int = 100) -> float:
    """Microseconds of host time per call of ``fn`` that does not wait for
    the card (the enqueue)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def device(fn, reps: int = 20):
    """Device time per call by ``torch.profiler`` (all of the call's kernels
    and memsets) and each one's launches a call by name, from the median of
    three profiles; ``(None, {})`` (not measured) if none recorded any."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    got = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in events)
        if total > 0:
            got.append((total / 1e3 / reps, {e.key[:70]: e.count / reps
                                             for e in events}))
    if not got:
        return None, {}
    return sorted(got, key=lambda g: g[0])[len(got) // 2]


def timings(fn, full: bool = True) -> dict:
    ms, launches = device(fn)
    row = {"device_ms": ms, "launches": launches,
           "ops_a_call": sum(launches.values()) if launches else None}
    if full:
        row.update(host_us=host_us(fn), event_ms=cuda_ms(fn))
    return row


def ptxas_rows(log: str) -> dict:
    names = re.findall(r"entry function '(\w+)'", log)
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores", log)
    return {n[-60:]: [int(r), int(sp)] for n, r, sp in zip(names, regs, spills)}


def inputs(gen):
    """The decode levels' 3-NN and weights, the head pooling's kNN and the
    resampling indices, from the checkout's own FPS and kNN kernels."""
    import torch
    from adaptpoint_tpu_torch.ops import fpsample, knn
    cloud = torch.randn((B, N_GAN, 3), generator=gen, device="cuda")
    cloud = (cloud / cloud.norm(dim=-1).amax(dim=1, keepdim=True)[..., None]
             ).contiguous()
    order = fpsample.furthest_point_sample_cuda(cloud, N_GAN // 2)
    half = torch.gather(cloud, 1, order.long()[..., None].expand(-1, -1, 3))
    levels = [cloud, half.contiguous()] + [half[:, :m].contiguous()
                                           for _, m, _ in LEVELS[1:]]
    decode = []
    for i, (n, m, c) in enumerate(LEVELS):
        idx = knn.knn_idx_cuda(3, levels[i + 1], levels[i])  # (B, n, 3)
        nb = torch.gather(levels[i + 1], 1,
                          idx.long().reshape(B, -1, 1).expand(-1, -1, 3))
        dist = (nb.reshape(B, n, 3, 3) - levels[i][:, :, None]).norm(dim=-1)
        recip = 1.0 / (dist + 1e-8)
        w = (recip / recip.sum(dim=2, keepdim=True)).contiguous()
        decode.append((n, m, c, idx.int().contiguous(), w))
    head = knn.knn_idx_cuda(24, levels[4], levels[0][:, :4].contiguous())
    resample = torch.argsort(torch.rand((B, N_GAN), generator=gen,
                                        device="cuda"), dim=1)[:, :1024]
    return decode, head.reshape(B, -1).int().contiguous(), \
        resample.int().contiguous()


def forced(module, name, value, fn):
    """``fn()`` with ``module.name`` answering ``value`` whatever it is
    asked."""
    keep = getattr(module, name)
    setattr(module, name, lambda *_a, **_k: value)
    try:
        return fn()
    finally:
        setattr(module, name, keep)


def design_rows(sr, call, args) -> dict:
    """Each design the checkout offers at this shape: its launch shape and
    device time, or why it does not run."""
    out = {}
    for name, design in sr.DESIGNS.items():
        try:
            t = sr.choose(*args, design=design)
            ms, launches = forced(sr, "choose", t, lambda: device(call))
            out[name] = {"tiling": list(t), "device_ms": ms,
                         "ops_a_call": sum(launches.values())}
        except (ValueError, RuntimeError) as e:
            out[name] = {"not_run": str(e)[:120]}
    return out


def child(root: str, designs: bool) -> dict:
    import torch
    sys.path.insert(0, os.path.abspath(root))
    from adaptpoint_tpu_torch.ops import _build
    from adaptpoint_tpu_torch.ops import fpinterp as fpi
    from adaptpoint_tpu_torch.ops import gather
    try:
        from adaptpoint_tpu_torch.ops import scatter_rows as sr
    except ImportError:  # a checkout before the redesign
        sr = None

    torch.backends.cuda.matmul.allow_tf32 = False
    names = ["fpinterp", "gather", "fps", "knn"]
    for n in names[:2]:  # built here, so that the build log reports them
        _build._lib_path(n).unlink(missing_ok=True)
    _build.build_all(names)
    res = {"root": os.path.abspath(root),
           "device": torch.cuda.get_device_name(0),
           "registers_spills": {n: ptxas_rows(_build.build_logs.get(n, ""))
                                for n in names[:2]}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    decode, head, resample = inputs(gen)
    rows = []
    for n, m, c, idx, w in decode:  # row 13
        feat = torch.randn((B, m, c), generator=gen, device="cuda").to(
            torch.bfloat16)
        g = torch.randn((B, n, c), generator=gen, device="cuda")

        def call(feat=feat, idx=idx, w=w, g=g):
            return fpi.weighted_gather3_bwd_cuda(feat, idx, w, g,
                                                 need_w=False)[0]

        f_c = feat.clone().requires_grad_()
        c_out = (torch.gather(f_c, 1, idx.long().reshape(B, -1, 1)
                              .expand(-1, -1, c)).reshape(B, n, 3, c)
                 * w[..., None]).sum(dim=2)
        first, second = call(), call()
        row = {"kernel": "row 13", "shape": [B, n, m, c],
               "bound_ms": 1e3 * (B * n * c * 4 + B * n * 24 + B * m * c * 2)
               / PEAK_BYTES, "kernel_ms": timings(call),
               "composite_bwd": timings(lambda: torch.autograd.grad(
                   c_out, f_c, g, retain_graph=True)),
               "launches_equal": bool(torch.equal(first, second))}
        if hasattr(fpi, "weighted_gather3_bwd_ordered"):
            row["equals_ordered_plain"] = bool(torch.equal(
                first, fpi.weighted_gather3_bwd_ordered(idx, w, g, m)))
            row["tiling"] = list(sr.choose(B, 3 * n, m, c, True, 4, True))
            if designs:
                row["designs"] = design_rows(sr, call,
                                             (B, 3 * n, m, c, True, 4, True))
        rows.append(row)
        del feat, g, f_c, c_out, first, second
        torch.cuda.empty_cache()
    shapes15 = [("head pooling", 128, 1024, head)] + [
        (f"decode {m} -> {n}", m, c, idx.reshape(B, -1).contiguous())
        for n, m, c, idx, _ in decode[::-1]] + [
        ("resample", N_GAN, 4, resample)]
    for tag, n_rows, c, idx in shapes15:  # row 15
        s = idx.shape[1]
        g = torch.randn((B, s, c), generator=gen, device="cuda")
        flat = (idx.long() + torch.arange(B, device="cuda")[:, None] * n_rows
                ).reshape(-1)

        def call(g=g, idx=idx, n_rows=n_rows):
            return gather.gather_rows_bwd_cuda(g, idx, n_rows)

        first, second = call(), call()
        row = {"kernel": "row 15", "case": tag, "shape": [B, s, n_rows, c],
               "bound_ms": 1e3 * (B * s * c * 4 + B * s * 4
                                  + B * n_rows * c * 4) / PEAK_BYTES,
               "kernel_ms": timings(call),
               "index_add": timings(lambda: torch.zeros(
                   (B * n_rows, c), device="cuda").index_add_(
                       0, flat, g.reshape(-1, c))),
               "launches_equal": bool(torch.equal(first, second))}
        if hasattr(gather, "gather_rows_bwd_ordered"):
            row["equals_ordered_plain"] = bool(torch.equal(
                first, gather.gather_rows_bwd_ordered(g, idx, n_rows)))
            row["tiling"] = list(sr.choose(B, s, n_rows, c, False, 4, True))
            if designs:
                row["designs"] = design_rows(sr, call,
                                             (B, s, n_rows, c, False, 4, True))
        rows.append(row)
        del g, flat, first, second
        torch.cuda.empty_cache()
    res["shapes"] = rows

    def total(sel, key):
        vals = [r[key]["device_ms"] for r in sel]
        return None if any(v is None for v in vals) else sum(vals)

    r13 = [r for r in rows if r["kernel"] == "row 13"]
    r15 = [r for r in rows if r["kernel"] == "row 15"
           and r["case"] != "resample"]
    res["sums"] = {
        "row 13, four levels": {"kernel": total(r13, "kernel_ms"),
                                "composite_bwd": total(r13, "composite_bwd"),
                                "event_ms": sum(r["kernel_ms"]["event_ms"]
                                                for r in r13),
                                "bound": sum(r["bound_ms"] for r in r13)},
        "row 15, f32 GAN step's five calls": {
            "kernel": total(r15, "kernel_ms"),
            "index_add": total(r15, "index_add"),
            "bound": sum(r["bound_ms"] for r in r15)}}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs="+", default=[REPO],
                    help="checkouts to time, in this order (default: this "
                         "one)")
    ap.add_argument("--designs", action="store_true",
                    help="also time every design the checkout offers")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=os.path.join(
        REPO, "build", "scatter_timing.jsonl"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if args.child:
        print(json.dumps(child(args.child, args.designs)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lines = [json.dumps({"nvidia_smi": smi})]
    print(lines[0], flush=True)
    for root in args.roots:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", root]
        got = subprocess.run(cmd + (["--designs"] if args.designs else []),
                             capture_output=True, text=True)
        if got.returncode != 0:
            sys.stderr.write(got.stdout + got.stderr)
            return got.returncode
        lines.append(got.stdout.strip().splitlines()[-1])
        print(lines[-1], flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
