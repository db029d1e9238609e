#!/usr/bin/env python3
"""Time the windowed max-pooled ball group's kernels (kernel rows 20 and 21)
of one or more checkouts of the PyTorch port on one NVIDIA GPU, in turns,
beside the full-N kernels (rows 7 and 8) on the same inputs.

    python3 scripts/torch_window_timing.py                 # this checkout
    python3 scripts/torch_window_timing.py --roots OLD . . OLD [--designs]

Each root is a directory that holds ``adaptpoint_tpu_torch``; each runs in a
child process of its own, which builds that checkout's kernels and prints
one JSON line. Inputs are seeded and the same for every root, as
``chip_smoke.py``'s ``window`` phase makes them: the augmentor's four
groupers of a B = 32 ``gan_step`` (N -> M, C, radius: 2048 -> 1024, 128,
0.1; 1024 -> 512, 256, 0.2; 512 -> 256, 512, 0.4; 256 -> 128, 1024, 0.8;
K = 24), normal clouds centred and scaled into the unit ball, centers drawn
without replacement, tm = 256 (128 where M is not a multiple of 256),
``window.pick_window``'s width, or the width the data needs where that one
does not hold every tile's span (``ok`` False; the picked width is timed
beside it).

For each shape:

- the forward and backward kernels alone (``ball_group_max_windowed_cuda``,
  ``ball_group_max_windowed_bwd_cuda``) and rows 7 and 8
  (``ball_group_max_cuda``, ``ball_group_max_bwd_cuda``) on the same cloud,
  centers and features;
- ``window_prep`` and the op ``ops.ball_group_max_windowed``, forward alone
  and forward plus backward through autograd, beside row 7/8's op;

each with the device time of a call (``torch.profiler``, every kernel and
memset of the call, with the device ops a call by name), the host's enqueue
time a call and the mean of a CUDA-event loop. The windowed kernels are
held against their plain versions on the card (forward outputs and
residuals exact and the same bits on a second launch, the backward within
the f32 reordering bound). Also each shape's byte bounds (inputs read once,
outputs written once) and the kernels' registers and spills from the
build. ``--designs`` adds the forward at every forced launch shape
(``window.fwd_tiling``'s design, centers a block and vector) and the
backward at every channel slice, where the checkout has them.
``--unchecked ROOT`` times ROOT without holding its outputs: a copy of the
sources with one piece of a kernel taken out, to see what that piece
costs. The card's name and power limit (``nvidia-smi``) lead the output;
``--out`` gets the same lines.

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
# --designs: forced forward tilings (design, centers a block, vector) and
# backward channel slices
DESIGNS = [(d, t, v) for d in ("bitmap", "sorted") for t in (32, 16, 8)
           for v in (4, 1)]
SLICES = (4, 8, 16, 32)
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
    and memsets) and its device ops a call by name, from the median of
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
    ms, ops = device(fn)
    return {"device_ms": ms, "ops": ops,
            "ops_a_call": sum(ops.values()) if ops else None,
            "host_us": host_us(fn), "event_ms": cuda_ms(fn, min_total_ms)}


def ptxas_rows(log: str) -> dict:
    names = re.findall(r"entry function '(\w+)'", log)
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores", log)
    return {n[-60:]: [int(r), int(sp)] for n, r, sp in zip(names, regs, spills)}


def bounds_ms(n, m, c, t) -> dict:
    """Byte bounds of one forward and one backward call (``chip_smoke.py``
    ``phase_window``'s): the cloud, features, order, windows, centers' and
    outputs' bytes, t the tiles a cloud."""
    fwd = (B * n * 12 + B * n * c * 4 + B * n * 4 + B * t * 4 + B * m * 8
           + B * m * 12 + 3 * B * m * c * 4 + 2 * B * m * c + B * m * 8
           + B * m * K * 4)
    bwd = (B * m * K * 4 + B * m * 8 + 2 * B * m * c + B * m * 12
           + 3 * B * m * c * 4 + B * n * 12 + B * n * c * 4)
    return {"fwd": 1e3 * fwd / PEAK_BYTES, "bwd": 1e3 * bwd / PEAK_BYTES}


def check(wnd, got, again, ref, back, back_ref, bargs, n):
    """Forward exact and bit-equal on a second launch; the backward within
    the reordering bound. Raises where not."""
    import torch
    names = ("new_xyz", "fi", "fmax", "fmin", "amax", "amin", "cnt", "idx",
             "qrow")
    for name, a, b, c in zip(names, got, ref, again):
        if not (torch.equal(a, b) and torch.equal(a, c)):
            raise AssertionError(f"forward {name} disagrees")
    idx, cnt, qrow, amax, amin, g_new, g_fi, g_fmax, g_fmin = bargs[:9]
    ones3, ones = torch.ones_like(g_new), torch.ones_like(g_fi)
    counts_x = wnd.ball_group_max_windowed_bwd_plain(
        idx, cnt, qrow, amax, amin, ones3, None, None, None, n)[0]
    counts_f = wnd.ball_group_max_windowed_bwd_plain(
        idx, cnt, qrow, amax, amin, None, ones, ones, ones, n)[1]
    a_x, a_f = wnd.ball_group_max_windowed_bwd_plain(
        idx, cnt, qrow, amax, amin, g_new.abs(), g_fi.abs(), g_fmax.abs(),
        g_fmin.abs(), n)
    errs = {}
    for name, a, b, cnts, mag in (("g_xyz", back[0], back_ref[0], counts_x,
                                   a_x),
                                  ("g_feats", back[1], back_ref[1], counts_f,
                                   a_f)):
        d = (a - b).abs()
        errs[name] = float(d.max())
        if not bool((d <= cnts * EPS32 * mag + 1e-30).all()):
            raise AssertionError(f"backward {name} past its bound: {errs}")
    return errs


def child(root: str, designs: bool, checked: bool = True) -> dict:
    import torch
    sys.path.insert(0, os.path.abspath(root))
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.ops import _build
    from adaptpoint_tpu_torch.ops import ballgroup_max as bgm
    from adaptpoint_tpu_torch.ops import window as wnd

    torch.backends.cuda.matmul.allow_tf32 = False
    names = ["window", "ballgroup_max"]
    for n in names:  # built here, so that the build log reports them
        _build._lib_path(n).unlink(missing_ok=True)
    _build.build_all(names)
    tiled = hasattr(wnd, "fwd_tiling")  # the launch shape is chosen
    res = {"root": os.path.abspath(root), "checked": checked,
           "device": torch.cuda.get_device_name(0),
           "registers_spills": {n: ptxas_rows(_build.build_logs.get(n, ""))
                                for n in names}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for n, m, c, r in SHAPES:
        pc = torch.randn((B, n, 3), generator=gen, device="cuda")
        pc = pc - pc.mean(dim=1, keepdim=True)
        xyz = (pc / pc.norm(dim=-1).amax(dim=1, keepdim=True)[..., None]
               ).contiguous()
        feats = torch.randn((B, n, c), generator=gen, device="cuda")
        q = torch.argsort(torch.rand((B, n), generator=gen, device="cuda"),
                          dim=1)[:, :m].int().contiguous()
        tm = 256 if m % 256 == 0 else 128
        w_pick = wnd.pick_window(wnd._round_up(n, 128), r, m, tm)
        prep = wnd.window_prep(xyz, q, r, tm, w_pick, stats_only=True)
        ok = bool(prep["ok"])
        w = w_pick if ok else int(prep["need"])
        if not ok:
            prep = wnd.window_prep(xyz, q, r, tm, w, stats_only=True)
        fargs = (r, K, xyz, q, feats, prep, w, tm)
        got = wnd.ball_group_max_windowed_cuda(*fargs)
        again = wnd.ball_group_max_windowed_cuda(*fargs)
        full = wnd.window_prep(xyz, q, r, tm, w)
        ref = wnd.ball_group_max_windowed_plain(*fargs[:5], full, w, tm)
        _, _, _, _, amax, amin, cnt, idx, qrow = got
        gs = [torch.randn((B, m, 3), generator=gen, device="cuda")] + [
            torch.randn((B, m, c), generator=gen, device="cuda")
            for _ in range(3)]
        bargs = (idx, cnt, qrow, amax, amin, *gs, n)
        back = wnd.ball_group_max_windowed_bwd_cuda(*bargs)
        back_ref = wnd.ball_group_max_windowed_bwd_plain(*bargs)
        errs = (check(wnd, got, again, ref, back, back_ref, bargs, n)
                if checked else None)
        del ref, again, back, back_ref, full
        # rows 7 and 8 on the same inputs
        r7 = bgm.ball_group_max_cuda(r, K, xyz, q, feats)
        r8args = (r7[6], q, r7[4], r7[5], *gs, n)
        x_req = xyz.clone().requires_grad_()
        f_req = feats.clone().requires_grad_()

        def win_fb():
            out = ops.ball_group_max_windowed(r, K, x_req, q, f_req, 1, 1,
                                              tm, w)
            return torch.autograd.grad(out, (x_req, f_req), gs)

        def full_fb():
            out = ops.ball_group_max(r, K, x_req, q, f_req)
            return torch.autograd.grad(out, (x_req, f_req), gs)

        with torch.no_grad():
            op_fwd = timings(lambda: ops.ball_group_max_windowed(
                r, K, xyz, q, feats, 1, 1, tm, w))
            row7_op_fwd = timings(lambda: ops.ball_group_max(r, K, xyz, q,
                                                             feats))
        row = {"shape": [B, n, m, c, K], "radius": r, "tm": tm, "w": w,
               "w_picked": w_pick, "ok_at_picked": ok,
               "max_abs_err_bwd": errs,
               "bound_ms": bounds_ms(n, m, c, m // tm),
               "kernel_fwd": timings(
                   lambda: wnd.ball_group_max_windowed_cuda(*fargs)),
               "kernel_bwd": timings(
                   lambda: wnd.ball_group_max_windowed_bwd_cuda(*bargs)),
               "row7_fwd": timings(
                   lambda: bgm.ball_group_max_cuda(r, K, xyz, q, feats)),
               "row8_bwd": timings(
                   lambda: bgm.ball_group_max_bwd_cuda(*r8args)),
               "window_prep": timings(lambda: wnd.window_prep(
                   xyz, q, r, tm, w, stats_only=True)),
               "op_fwd": op_fwd, "row7_op_fwd": row7_op_fwd,
               "op_fwd_bwd": timings(win_fb),
               "row78_op_fwd_bwd": timings(full_fb)}
        if not ok:
            p_pick = wnd.window_prep(xyz, q, r, tm, w_pick, stats_only=True)
            row["kernel_fwd_at_picked_w"] = timings(
                lambda: wnd.ball_group_max_windowed_cuda(
                    r, K, xyz, q, feats, p_pick, w_pick, tm))
        if tiled:
            row["fwd_tiling"] = list(wnd.fwd_tiling(B, n, m, c, K, tm, w))
            row["bwd_tiling"] = list(wnd.bwd_tiling(n, c))
        if designs and tiled:
            row["fwd_designs"], row["bwd_slices"] = {}, {}
            for d in DESIGNS:
                try:
                    tl = wnd.fwd_tiling(B, n, m, c, K, tm, w, True, *d)
                except ValueError:
                    continue  # centers that do not divide tm
                forced = wnd.ball_group_max_windowed_cuda(*fargs, tiling=tl)
                if checked and not all(torch.equal(a, b)
                                       for a, b in zip(forced, got)):
                    raise AssertionError(f"forced {tl} disagrees")
                ms, _ = device(lambda: wnd.ball_group_max_windowed_cuda(
                    *fargs, tiling=tl))
                row["fwd_designs"]["/".join(map(str, d))] = ms
            for s in SLICES:
                tl = wnd.bwd_tiling(n, c, s)
                ms, _ = device(lambda: wnd.ball_group_max_windowed_bwd_cuda(
                    *bargs, tiling=tl))
                row["bwd_slices"][str(s)] = {"tiling": list(tl),
                                             "device_ms": ms}
        rows.append(row)
        del feats, gs, got, x_req, f_req, r7, r8args
        torch.cuda.empty_cache()
    res["shapes"] = rows
    keys = ("kernel_fwd", "kernel_bwd", "row7_fwd", "row8_bwd", "window_prep",
            "op_fwd", "row7_op_fwd", "op_fwd_bwd", "row78_op_fwd_bwd")
    res["sums"] = {
        key: {unit: (None if any(r[key][unit] is None for r in rows)
                     else sum(r[key][unit] for r in rows))
              for unit in ("device_ms", "event_ms")} for key in keys}
    res["sums"]["bound_fwd_ms"] = sum(r["bound_ms"]["fwd"] for r in rows)
    res["sums"]["bound_bwd_ms"] = sum(r["bound_ms"]["bwd"] for r in rows)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs="+", default=[REPO],
                    help="checkouts to time, in this order (default: this "
                         "one)")
    ap.add_argument("--designs", action="store_true",
                    help="also time every forced forward tiling and "
                         "backward slice")
    ap.add_argument("--unchecked", nargs="*", default=[],
                    help="roots (among --roots) timed without holding their "
                         "outputs: variants with a piece taken out")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--child-unchecked", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--out", default=os.path.join(
        REPO, "build", "window_timing.jsonl"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if args.child:
        print(json.dumps(child(args.child, args.designs,
                               not args.child_unchecked)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lines = [json.dumps({"nvidia_smi": smi})]
    print(lines[0], flush=True)
    for root in args.roots:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", root]
        unchecked = root in args.unchecked
        got = subprocess.run(cmd + (["--designs"] if args.designs else [])
                             + (["--child-unchecked"] if unchecked
                                else []),
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
