#!/usr/bin/env python3
"""Time the max-pooled ball group's kernels (kernel rows 7 and 8) and its op
of one or more checkouts of the PyTorch port on one NVIDIA GPU, in turns.

    python3 scripts/torch_bgmax_timing.py                # this checkout
    python3 scripts/torch_bgmax_timing.py --roots OLD . . OLD [--sweep]

Each root is a directory that holds ``adaptpoint_tpu_torch``; each runs in a
child process of its own, which builds that checkout's kernels and prints
one JSON line. Inputs are seeded and the same for every root: the
augmentor's four groupers of a B = 32 ``gan_step`` (N -> M, C, radius:
2048 -> 1024, 128, 0.1; 1024 -> 512, 256, 0.2; 512 -> 256, 512, 0.4;
256 -> 128, 1024, 0.8; K = 24), on a unit-ball cloud, its FPS half and that
half's prefixes, with f32 and with bf16 features.

For each shape and feature type:

- the forward and backward kernels alone (``ball_group_max_cuda``,
  ``ball_group_max_bwd_cuda``); a checkout whose kernels take only f32
  features runs them on the bf16 features cast up (the values its op hands
  them);
- the op ``ops.ball_group_max``, forward alone and forward plus backward
  through autograd, casts included where the checkout makes them;

each with the device time of a call alone (``torch.profiler``, every kernel
and memset of the call, with their launches a call by name), the host's
enqueue time a call and the mean of a CUDA-event loop; both kernels held
against their plain versions on the card (forward outputs and slots exact,
the feature gradient within the f32 reordering bound, plus one bf16 ulp for
bf16). Also each shape's byte bound (inputs read once, outputs written once,
at the features' width) and the kernels' registers and spills from the
build. ``--sweep`` adds the backward at other channel slices (the wrapper's
``bwd_tiling`` replaced by ``bwd_tiling(N, C, s)``) where the checkout has
them. The card's name and power limit
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
B, K = 32, 24
# the augmentor's groupers: (N, M, C, radius)
SHAPES = [(2048, 1024, 128, 0.1), (1024, 512, 256, 0.2),
          (512, 256, 512, 0.4), (256, 128, 1024, 0.8)]
SWEEP = (4, 8, 16, 32)  # channels a backward block, --sweep
PEAK_BYTES = 3.35e12  # H100 SXM
EPS32 = 2.0 ** -23


def cuda_ms(fn, min_total_ms: float = 100.0) -> float:
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


def timings(fn, min_total_ms: float = 50.0) -> dict:
    ms, launches = device(fn)
    return {"device_ms": ms, "launches": launches,
            "launches_a_call": sum(launches.values()) if launches else None,
            "host_us": host_us(fn), "event_ms": cuda_ms(fn, min_total_ms)}


def ptxas_rows(log: str) -> dict:
    names = re.findall(r"entry function '(\w+)'", log)
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores", log)
    return {n[-60:]: [int(r), int(sp)] for n, r, sp in zip(names, regs, spills)}


def bounds_ms(n, m, c, width) -> dict:
    """Byte bounds of one forward and one backward call: features,
    cotangents and the three value outputs at ``width`` bytes, slots at one,
    xyz and g_new f32, idx and qidx i32."""
    fwd = (B * n * 12 + B * n * c * width + B * m * 4 + B * m * 12
           + 3 * B * m * c * width + 2 * B * m * c + B * m * K * 4)
    bwd = (B * m * K * 4 + B * m * 4 + B * m * 12 + 3 * B * m * c * width
           + 2 * B * m * c + B * n * 12 + B * n * c * width)
    return {"fwd": 1e3 * fwd / PEAK_BYTES, "bwd": 1e3 * bwd / PEAK_BYTES}


def check(bgm, got, ref, back, back_ref, idx, q, amax, amin, gs, n, bf16):
    """Forward exact; the backward within the reordering bound (+ one bf16
    ulp for bf16). Raises where not."""
    import torch
    for name, a, b in zip(("new_xyz", "fi", "fmax", "fmin", "amax", "amin",
                           "idx"), got, ref):
        if not torch.equal(a.float() if a.is_floating_point() else a,
                           b.float() if b.is_floating_point() else b):
            raise AssertionError(f"forward {name} disagrees")
    g32 = [g.float() for g in gs]
    ones3, ones = torch.ones_like(g32[0]), torch.ones_like(g32[1])
    counts_x = bgm.ball_group_max_bwd_plain(idx, q, amax, amin, ones3, None,
                                            None, None, n)[0]
    counts_f = bgm.ball_group_max_bwd_plain(idx, q, amax, amin, None, ones,
                                            ones, ones, n)[1]
    a_x, a_f = bgm.ball_group_max_bwd_plain(
        idx, q, amax, amin, *(g.abs() for g in g32), n)
    bound_x = counts_x * EPS32 * a_x + 1e-30
    bound_f = counts_f * EPS32 * a_f + 1e-30
    if bf16:
        bound_f = bound_f + 2.0 ** -7 * (back_ref[1].float().abs() + bound_f)
    errs = {}
    for name, a, b, bound in (("g_xyz", back[0], back_ref[0], bound_x),
                              ("g_feats", back[1], back_ref[1], bound_f)):
        d = (a.float() - b.float()).abs()
        errs[name] = float(d.max())
        if not bool((d <= bound).all()):
            raise AssertionError(f"backward {name} past its bound: {errs}")
    return errs


def child(root: str, sweep: bool) -> dict:
    import torch
    sys.path.insert(0, os.path.abspath(root))
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.ops import _build, fpsample
    from adaptpoint_tpu_torch.ops import ballgroup_max as bgm

    torch.backends.cuda.matmul.allow_tf32 = False
    names = ["ballgroup_max", "fps"]
    for n in names:  # built here, so that the build log reports them
        _build._lib_path(n).unlink(missing_ok=True)
    _build.build_all(names)
    typed = hasattr(bgm, "fwd_tiling")  # the kernels take bf16 features
    res = {"root": os.path.abspath(root),
           "device": torch.cuda.get_device_name(0),
           "kernels_take_bf16": typed,
           "registers_spills": ptxas_rows(
               _build.build_logs.get("ballgroup_max", ""))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    cloud = torch.randn((B, 2048, 3), generator=gen, device="cuda")
    cloud = (cloud / cloud.norm(dim=-1).amax(dim=1, keepdim=True)[..., None]
             ).contiguous()
    order = fpsample.furthest_point_sample_cuda(cloud, 1024)
    half = torch.gather(cloud, 1, order.long()[..., None].expand(-1, -1, 3))
    levels = [cloud, half.contiguous()] + [half[:, :m].contiguous()
                                          for m in (512, 256)]
    rows = []
    for i, (n, m, c, r) in enumerate(SHAPES):
        xyz = levels[i]
        q = (order if i == 0 else torch.arange(
            m, device="cuda", dtype=torch.int32).expand(B, m)).contiguous()
        for dt in (torch.float32, torch.bfloat16):
            bf16 = dt == torch.bfloat16
            feats = torch.randn((B, n, c), generator=gen,
                                device="cuda").to(dt)
            gs = [torch.randn((B, m, 3), generator=gen, device="cuda")] + [
                torch.randn((B, m, c), generator=gen, device="cuda").to(dt)
                for _ in range(3)]
            # what the kernels take: bf16 as it is, or cast up
            kf = feats if typed else feats.float()
            kg = gs if typed else [g.float() for g in gs]
            kw = {"feat_dtype": dt} if typed else {}
            got = bgm.ball_group_max_cuda(r, K, xyz, q, kf)
            ref = bgm.ball_group_max_plain(r, K, xyz, q, feats)
            idx, amax, amin = got[6], got[4], got[5]
            back = bgm.ball_group_max_bwd_cuda(idx, q, amax, amin, *kg, n,
                                               **kw)
            back_ref = bgm.ball_group_max_bwd_plain(idx, q, amax, amin, *kg,
                                                    n)
            errs = check(bgm, got, ref, back, back_ref, idx, q, amax, amin,
                         kg, n, bf16 and typed)
            del ref, back, back_ref
            x_req = xyz.clone().requires_grad_()
            f_req = feats.clone().requires_grad_()

            def op_fwd_bwd():
                out = ops.ball_group_max(r, K, x_req, q, f_req)
                return torch.autograd.grad(out, (x_req, f_req), gs)

            row = {"shape": [B, n, m, c, K], "radius": r,
                   "dtype": str(dt).split(".")[1], "max_abs_err": errs,
                   "bound_ms": bounds_ms(n, m, c, 2 if bf16 else 4),
                   "kernel_fwd": timings(
                       lambda: bgm.ball_group_max_cuda(r, K, xyz, q, kf)),
                   "kernel_bwd": timings(
                       lambda: bgm.ball_group_max_bwd_cuda(
                           idx, q, amax, amin, *kg, n, **kw)),
                   "op_fwd": timings(
                       lambda: ops.ball_group_max(r, K, xyz, q, feats)),
                   "op_fwd_bwd": timings(op_fwd_bwd)}
            if typed:
                row["fwd_tiling"] = list(bgm.fwd_tiling(B, n, m, c, K, dt))
                row["bwd_tiling"] = list(bgm.bwd_tiling(n, c))
            if sweep and typed:
                row["bwd_slices"] = {}
                picker = bgm.bwd_tiling
                for s in SWEEP:
                    tl = picker(n, c, s)
                    bgm.bwd_tiling = lambda *_, tl=tl: tl  # forced here
                    try:
                        ms, _ = device(lambda: bgm.ball_group_max_bwd_cuda(
                            idx, q, amax, amin, *kg, n, **kw))
                    finally:
                        bgm.bwd_tiling = picker
                    row["bwd_slices"][str(s)] = {"tiling": list(tl),
                                                 "device_ms": ms}
            rows.append(row)
            del feats, gs, kf, kg, got, x_req, f_req
            torch.cuda.empty_cache()
    res["shapes"] = rows
    res["sums"] = {}
    for dt in ("float32", "bfloat16"):
        sel = [r for r in rows if r["dtype"] == dt]
        res["sums"][dt] = {
            key: (None if any(r[key]["device_ms"] is None for r in sel)
                  else sum(r[key]["device_ms"] for r in sel))
            for key in ("kernel_fwd", "kernel_bwd", "op_fwd", "op_fwd_bwd")}
        res["sums"][dt]["bound_fwd_ms"] = sum(r["bound_ms"]["fwd"]
                                              for r in sel)
        res["sums"][dt]["bound_bwd_ms"] = sum(r["bound_ms"]["bwd"]
                                              for r in sel)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs="+", default=[REPO],
                    help="checkouts to time, in this order (default: this "
                         "one)")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the backward at other channel slices")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=os.path.join(
        REPO, "build", "bgmax_timing.jsonl"))
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
