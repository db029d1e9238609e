#!/usr/bin/env python3
"""Time the ball group's kernels (kernel rows 2 and 4) of one or more
checkouts of the PyTorch port on one NVIDIA GPU, in turns.

    python3 scripts/torch_ballgroup_timing.py                # this checkout
    python3 scripts/torch_ballgroup_timing.py --roots OLD . . OLD [--sweep]

Each root is a directory that holds ``adaptpoint_tpu_torch``; each runs in a
child process of its own, which builds that checkout's kernels and prints
one JSON line. Inputs are seeded and the same for every root: PointNeXt-S's
four SA stages from N = 1024 (N -> M, C, radius: 1024 -> 512, 32, 0.15;
512 -> 256, 64, 0.225; 256 -> 128, 128, 0.3375; 128 -> 64, 256, 0.50625;
K = 32, dp relative and normalised) on a unit-ball cloud, its FPS half and
that half's prefixes: at B = 32 (the train step and the unfused B = 32
serving forward; forward and backward) and at B = 1 and 8 (the unfused
serving forward's other buckets; forward only).

For each shape:

- the forward kernel ``ball_group_cuda`` (row 2) and, at B = 32, the
  backward kernel ``ball_group_bwd_cuda`` (row 4) with all three
  cotangents;
- each with the device time of a call alone (``torch.profiler``, every
  kernel and memset of the call, with their launches a call by name), the
  host's enqueue time a call and the mean of a CUDA-event loop;
- both kernels held against their plain versions on the card (forward bit
  for bit, the backward within the f32 reordering bound n 2^-23 sum|addend|
  per element);
- each call's byte bound (inputs read once, outputs written once);
- a stand-in for each, not the same function: for row 2 ``torch.gather``
  of the neighbour rows of ``[xyz || feats]`` by the kernel's ``idx``
  (without the ball query, the centers or the relative dp), for row 4
  ``index_add_`` of ``g_dpfj``'s feature columns onto zeros (without the
  dp columns and the centers' terms).

Also the kernels' registers and spills from the build. ``--sweep`` adds
the forward at other tiles of centers (the wrapper's ``fwd_tiling``
replaced) where the checkout has them. The card's name and power limit
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
K = 32
# PointNeXt-S's SA stages from N = 1024: (N, M, C, radius)
STAGES = [(1024, 512, 32, 0.15), (512, 256, 64, 0.225),
          (256, 128, 128, 0.3375), (128, 64, 256, 0.50625)]
BATCHES = (32, 8, 1)  # B = 32 forward and backward, 8 and 1 forward only
FWD_SWEEP = (4, 8, 16, 32)  # centers a forward block, --sweep
PEAK_BYTES = 3.35e12  # H100 SXM
EPS32 = 2.0 ** -23


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
    three profiles (a profile can miss part of its window's device
    activity); ``(None, {})`` (not measured) if none recorded any."""
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


def timings(fn) -> dict:
    ms, launches = device(fn)
    return {"device_ms": ms, "launches": launches,
            "launches_a_call": sum(launches.values()) if launches else None,
            "host_us": host_us(fn), "event_ms": cuda_ms(fn)}


def ptxas_rows(log: str) -> dict:
    names = re.findall(r"entry function '(\w+)'", log)
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores", log)
    return {n[-60:]: [int(r), int(sp)] for n, r, sp in zip(names, regs, spills)}


def bounds_ms(b, n, m, c) -> dict:
    """Byte bounds of one forward and one backward call."""
    fwd = (b * n * 12 + b * n * c * 4 + b * m * 4 + b * m * 12 + b * m * c * 4
           + b * K * m * (3 + c) * 4 + b * m * K * 4)
    bwd = (b * m * K * 4 + b * m * 4 + b * m * 12 + b * m * c * 4
           + b * K * m * (3 + c) * 4 + b * n * (3 + c) * 4)
    return {"fwd": 1e3 * fwd / PEAK_BYTES, "bwd": 1e3 * bwd / PEAK_BYTES}


def bwd_errors(bg, r, idx, q, g_new, g_fi, g_dpfj, n, back) -> dict:
    """The backward against its plain version within n 2^-23 sum|addend|
    per element (the count of addends and their magnitudes from the plain
    version on ones and on absolute values). Raises where not."""
    import torch
    from adaptpoint_tpu_torch.ops.geometry import inv_radius
    ref = bg.ball_group_bwd_plain(r, idx, q, g_new, g_fi, g_dpfj, n, True,
                                  True)
    b, k, m, _ = g_dpfj.shape
    one = torch.ones((b, k, m, 4), device=idx.device)
    counts = bg.ball_group_bwd_plain(r, idx, q, None, one[:, 0, :, :1], one,
                                     n, False, False)[1] + k
    a_dp = g_dpfj[..., :3].abs() * inv_radius(r)
    a_x, a_f = bg.ball_group_bwd_plain(
        r, idx, q, g_new.abs() + a_dp.sum(dim=1), g_fi.abs(),
        torch.cat([a_dp, g_dpfj[..., 3:].abs()], -1), n, False, False)
    errs = {}
    for name, got, want, a in (("g_xyz", back[0], ref[0], a_x),
                               ("g_feats", back[1], ref[1], a_f)):
        d = (got - want).abs()
        errs[name] = float(d.max()) if d.numel() else 0.0
        if not bool((d <= counts * EPS32 * a + 1e-30).all()):
            raise AssertionError(f"backward {name} past its bound: {errs}")
    return errs


def stage_inputs(b, gen, fps):
    """(xyz, qidx, feats, radius) of the four stages at batch ``b``."""
    import torch
    xyz = torch.randn((b, STAGES[0][0], 3), generator=gen, device="cuda")
    xyz = (xyz / xyz.norm(dim=-1).amax(dim=1, keepdim=True)[..., None]
           ).contiguous()
    out = []
    for i, (n, m, c, r) in enumerate(STAGES):
        q = (fps(xyz, m) if i == 0 else torch.arange(
            m, device="cuda", dtype=torch.int32).expand(b, m)).contiguous()
        feats = torch.randn((b, n, c), generator=gen, device="cuda")
        out.append((xyz, q, feats, r))
        xyz = torch.gather(xyz, 1, q.long()[..., None].expand(-1, -1, 3)
                           ).contiguous()
    return out


def forced(module, name, value, fn):
    """``fn()`` with ``module.name`` answering ``value`` whatever it is
    asked."""
    keep = getattr(module, name)
    setattr(module, name, lambda *_a, **_k: value)
    try:
        return fn()
    finally:
        setattr(module, name, keep)


def child(root: str, sweep: bool) -> dict:
    import torch
    sys.path.insert(0, os.path.abspath(root))
    from adaptpoint_tpu_torch.ops import _build, fpsample
    from adaptpoint_tpu_torch.ops import ballgroup as bg

    torch.backends.cuda.matmul.allow_tf32 = False
    names = ["ballgroup", "ballgroup_bwd", "fps"]
    for n in names:  # built here, so that the build log reports them
        _build._lib_path(n).unlink(missing_ok=True)
    _build.build_all(names)
    tiled = hasattr(bg, "fwd_tiling")
    res = {"root": os.path.abspath(root),
           "device": torch.cuda.get_device_name(0),
           "registers_spills": {
               n: ptxas_rows(_build.build_logs.get(n, ""))
               for n in ("ballgroup", "ballgroup_bwd")}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b in BATCHES:
        for i, (xyz, q, feats, r) in enumerate(
                stage_inputs(b, gen, fpsample.furthest_point_sample_cuda)):
            n, m, c, _ = STAGES[i]
            args = (r, K, xyz, q, feats, True, True)
            got = bg.ball_group_cuda(*args)
            ref = bg.ball_group_plain(*args)
            for name, a, want in zip(("new_xyz", "fi", "dpfj", "idx"), got,
                                     ref):
                if not torch.equal(a, want):
                    raise AssertionError(f"forward {name} disagrees at "
                                         f"B={b} stage {i + 1}")
            idx = got[3]
            del ref
            # stand-in: the neighbour rows of [xyz || feats] by idx
            cat = torch.cat([xyz, feats], -1)
            flat = idx.long().reshape(b, m * K, 1).expand(-1, -1, 3 + c)
            row = {"batch": b, "stage": i + 1, "shape": [b, n, m, c, K],
                   "bound_ms": bounds_ms(b, n, m, c),
                   "fwd": timings(lambda: bg.ball_group_cuda(*args)),
                   "fwd_stand_in": timings(
                       lambda: torch.gather(cat, 1, flat))}
            if tiled:
                row["fwd_tiling"] = list(bg.fwd_tiling(b, n, m, c, K))
            if sweep and tiled:
                row["fwd_tiles"] = {}
                for tm in FWD_SWEEP:
                    tl = bg.fwd_tiling(b, n, m, c, K)._replace(
                        tm=tm, cap=min((tm * (c + 3) + 6) // 4 * 4, 3072))
                    tl = tl._replace(use_xs=bg.fwd_smem_bytes(
                        tm, K, n, True, tl.cap) <= 115712)
                    ms, _ = forced(bg, "fwd_tiling", tl, lambda: device(
                        lambda: bg.ball_group_cuda(*args)))
                    row["fwd_tiles"][str(tm)] = {"tiling": list(tl),
                                                 "device_ms": ms}
            del cat, flat
            if b == 32:
                g_new = torch.randn((b, m, 3), generator=gen, device="cuda")
                g_fi = torch.randn((b, m, c), generator=gen, device="cuda")
                g_dpfj = torch.randn((b, K, m, 3 + c), generator=gen,
                                     device="cuda")
                bargs = (r, idx, q, g_new, g_fi, g_dpfj, n, True, True)
                back = bg.ball_group_bwd_cuda(*bargs)
                row["max_abs_err"] = bwd_errors(bg, r, idx, q, g_new, g_fi,
                                                g_dpfj, n, back)
                del back
                rows_idx = idx.long().permute(0, 2, 1).reshape(-1)
                rows_idx = rows_idx + torch.arange(
                    b, device="cuda").repeat_interleave(K * m) * n
                g_f = g_dpfj[..., 3:].reshape(-1, c)
                row["bwd"] = timings(lambda: bg.ball_group_bwd_cuda(*bargs))
                row["bwd_stand_in"] = timings(
                    lambda: torch.zeros((b * n, c), device="cuda")
                    .index_add_(0, rows_idx, g_f))
                del g_new, g_fi, g_dpfj, g_f, rows_idx
            rows.append(row)
            torch.cuda.empty_cache()
    res["shapes"] = rows
    res["sums"] = {}
    for b in BATCHES:
        sel = [r for r in rows if r["batch"] == b]
        keys = ("fwd", "fwd_stand_in") + (
            ("bwd", "bwd_stand_in") if b == 32 else ())
        res["sums"][str(b)] = {
            key: (None if any(r[key]["device_ms"] is None for r in sel)
                  else sum(r[key]["device_ms"] for r in sel))
            for key in keys}
        res["sums"][str(b)]["bound_fwd_ms"] = sum(r["bound_ms"]["fwd"]
                                                  for r in sel)
        if b == 32:
            res["sums"][str(b)]["bound_bwd_ms"] = sum(
                r["bound_ms"]["bwd"] for r in sel)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs="+", default=[REPO],
                    help="checkouts to time, in this order (default: this "
                         "one)")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the forward at other tiles of centers")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=os.path.join(
        REPO, "build", "ballgroup_timing.jsonl"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if args.child:
        print(json.dumps(child(args.child, args.sweep)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lines = [json.dumps({"nvidia_smi": smi})]
    print(lines[0], flush=True)
    for root in args.roots:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", root]
        got = subprocess.run(cmd + (["--sweep"] if args.sweep else []),
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
