#!/usr/bin/env python3
"""Time the fused train-BN stage's four passes (kernel rows 16-19) of one or
more checkouts of the PyTorch port on one NVIDIA GPU, in turns.

    python3 scripts/torch_trainbn_timing.py                # this checkout
    python3 scripts/torch_trainbn_timing.py --roots OLD . . OLD [--designs]

Each root is a directory that holds ``adaptpoint_tpu_torch``; each runs in a
child process of its own, which builds that checkout's kernels and prints
one JSON line. Inputs are seeded and the same for every root: PointNeXt-S's
four strided SA stages of a B=32 train step, (N -> M, C, mid, cout, radius)
= (1024 -> 512, 32, 32, 64, 0.15) ... (128 -> 64, 256, 256, 512, 0.50625),
K = 32, each stage's centers the FPS picks of its cloud and its cloud the
previous stage's centers, seeded features, weights and BatchNorm
parameters, and seeded cotangents of the pooled output, fi and new_xyz.
The statistics and the forward come from the checkout's own passes 1 and 2,
as in a train step.

For each pass at each stage: the device time of a call alone
(``torch.profiler``, every kernel and memset of the call, with each device
op's launches and ms a call by name, from the median of three profiles), the host's enqueue
time a call, the mean of a CUDA-event loop, and each float output's largest
distance from the checkout's plain pass on the same inputs over that
output's largest entry, and for rows 16 and 17 whether a second call gives
the same bits. Where the checkout's forward returns the weight copies that
its pass 3 reads (a tenth output), pass 3 is timed on them, as in a train
step. Also the kernels' registers and spills from the build.
``--designs`` also times the passes of a checkout that offers launch shapes
to force (``satrainbn.DESIGN``: rows 18 and 19 under "rows", row 17 under
"fwd", row 16 under "stats") at each rows a block (128, 64, 32, where they
fit). The card's name and power limit (``nvidia-smi``) lead the output;
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
B, K, N0 = 32, 32, 1024
# PointNeXt-S's strided SA stages: (N, M, C, mid, cout, radius)
STAGES = [(1024, 512, 32, 32, 64, 0.15), (512, 256, 64, 64, 128, 0.225),
          (256, 128, 128, 128, 256, 0.3375),
          (128, 64, 256, 256, 512, 0.50625)]
PASSES = ("stats", "fwd", "bwd_w2", "bwd_x")


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
    reps = int(min(100, max(5, min_total_ms / one)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int = 20) -> float:
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


def device(fn, reps: int = 5):
    """Device time per call by ``torch.profiler`` (all of the call's kernels
    and memsets) and each one's launches and device ms a call by name, from
    the median of three profiles; ``(None, {})`` (not measured) if none
    recorded any."""
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
            got.append((total / 1e3 / reps,
                        {e.key[:70]: [e.count / reps,
                                      e.self_device_time_total / 1e3 / reps]
                         for e in events}))
    if not got:
        return None, {}
    return sorted(got, key=lambda g: g[0])[len(got) // 2]


def timings(fn, full: bool = True) -> dict:
    ms, ops = device(fn)
    row = {"device_ms": ms, "ops": ops,
           "ops_a_call": sum(v[0] for v in ops.values()) if ops else None}
    if full:
        row.update(host_us=host_us(fn), event_ms=cuda_ms(fn))
    return row


def ptxas_rows(log: str) -> dict:
    names = re.findall(r"entry function '(\w+)'", log)
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores", log)
    return {n[-60:]: [int(r), int(sp)] for n, r, sp in zip(names, regs, spills)}


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref| (floored at 1e-30)."""
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def stage_inputs(gen):
    """Each stage's (xyz, qidx, feats, w1, g1, b1, w2, g2, b2, radius) and
    cotangents (g_out, g_fi, g_new), the clouds chained by FPS."""
    import torch
    from adaptpoint_tpu_torch.ops import fpsample
    cloud = torch.randn((B, N0, 3), generator=gen, device="cuda")
    cloud = (cloud / cloud.norm(dim=-1).amax(dim=1, keepdim=True)[..., None]
             ).contiguous()
    out = []
    for n, m, c, mid, cout, radius in STAGES:
        qidx = fpsample.furthest_point_sample_cuda(cloud, m).int().contiguous()

        def rnd(*shape, scale=1.0, shift=0.0):
            return (torch.randn(shape, generator=gen, device="cuda") * scale
                    + shift).contiguous()

        feats = rnd(B, n, c)
        params = (rnd(c + 3, mid, scale=(c + 3) ** -0.5),
                  rnd(mid, scale=0.2, shift=1.0), rnd(mid, scale=0.2),
                  rnd(mid, cout, scale=mid ** -0.5),
                  rnd(cout, scale=0.2, shift=1.0), rnd(cout, scale=0.2))
        cot = (rnd(B, m, cout), rnd(B, m, c), rnd(B, m, 3))
        out.append((cloud, qidx, feats) + params + (radius,) + cot)
        cloud = torch.gather(cloud, 1, qidx.long()[..., None].expand(-1, -1, 3)
                             ).contiguous()
    return out


def child(root: str, designs: bool) -> dict:
    import torch
    sys.path.insert(0, os.path.abspath(root))
    from adaptpoint_tpu_torch.ops import _build
    from adaptpoint_tpu_torch.ops import satrainbn as S

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    handover = hasattr(S, "tf32x3_mm")  # the redesigned passes' signatures
    _build._lib_path("satrainbn").unlink(missing_ok=True)
    _build.build_all(["satrainbn", "fps"])
    res = {"root": os.path.abspath(root),
           "device": torch.cuda.get_device_name(0),
           "handover": handover,
           "registers_spills": ptxas_rows(_build.build_logs.get("satrainbn",
                                                                ""))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for si, (xyz, qidx, feats, w1, g1, b1, w2, g2, b2, radius, g_out, g_fi,
             g_new) in enumerate(stage_inputs(gen)):
        Bq, M = qidx.shape
        n = Bq * M * K
        mid, cout = w2.shape
        rel, ndp = True, False
        idx, sv, svv = S.stats_cuda(radius, K, xyz, qidx, feats, rel, ndp)
        mu1, var1, r1, a1, nb1 = S._bn1(sv, svv, w1, g1, b1, n, 1e-5)
        fargs = (radius, xyz, qidx, feats, idx, w1, a1, nb1, w2, rel, ndp)
        f = S.fwd_cuda(*fargs)
        wt = tuple(f[9:])  # the forward's weight copies, where it has them
        mu2, var2, r2, a2, c2 = S._bn2(f[6], f[7], g2, b2, n, 1e-5)
        pos = a2 > 0
        ystar = torch.where(pos, f[2], f[3])
        slot = torch.where(pos, f[4], f[5])
        xhat2 = (ystar - mu2) * r2
        p2, q2c = S._bwd_consts(g_out.sum((0, 1)) / n,
                                (g_out * xhat2).sum((0, 1)) / n, a2, mu2, r2)
        if handover:
            pre = (radius, xyz, qidx, feats, idx, w1, a1, nb1, w2, mu1, r1,
                   a2, p2, q2c, slot, g_out, f[8])
            wargs, pargs = pre + wt + (rel, ndp), pre + (rel, ndp)
            w2_out = S.bwd_w2_cuda(*wargs)
            p1, q1c = S._bwd_consts(w2_out[1] / n, w2_out[2] / n, a1, mu1, r1)
            xargs = (radius, xyz, qidx, feats, idx, w1, w2_out[4], w2_out[3],
                     a1, p1, q1c, g_fi, g_new, rel, ndp)
        else:
            wargs = (radius, xyz, qidx, feats, idx, w1, a1, nb1, w2, mu1, r1,
                     a2, p2, q2c, slot, g_out, rel, ndp)
            pargs = wargs
            w2_out = S.bwd_w2_cuda(*wargs)
            p1, q1c = S._bwd_consts(w2_out[1] / n, w2_out[2] / n, a1, mu1, r1)
            xargs = (radius, xyz, qidx, feats, idx, w1, a1, nb1, w2, a2, p2,
                     q2c, p1, q1c, slot, g_out, g_fi, g_new, rel, ndp)
        calls = {"stats": (lambda: S.stats_cuda(radius, K, xyz, qidx, feats,
                                                rel, ndp),
                           lambda: S.stats_plain(radius, K, xyz, qidx, feats,
                                                 rel, ndp)),
                 "fwd": (lambda: S.fwd_cuda(*fargs),
                         lambda: S.fwd_plain(*fargs)),
                 "bwd_w2": (lambda: S.bwd_w2_cuda(*wargs),
                            lambda: S.bwd_w2_plain(*pargs)),
                 "bwd_x": (lambda: S.bwd_x_cuda(*xargs),
                           lambda: S.bwd_x_plain(*xargs))}
        row = {"stage": si + 1, "shape": [Bq, xyz.shape[1], M, feats.shape[2],
                                          mid, cout, K]}
        for name in PASSES:
            kern, plain = calls[name]
            got, ref = kern(), plain()
            errs = {}
            for j, (a, b) in enumerate(zip(got, ref)):
                if a.is_floating_point():
                    errs[str(j)] = rel_err(a, b)
                else:
                    errs[str(j)] = int((a != b).sum())
            row[name] = {**timings(kern), "rel_err": errs}
            if name in ("stats", "fwd"):
                again = kern()
                row[name]["same_bits_again"] = all(
                    torch.equal(a, b) for a, b in zip(got, again))
                del again
            del got, ref
        if handover and designs and hasattr(S, "DESIGN"):
            row["designs"] = {}
            # (DESIGN key, passes it forces, the plan kinds it sets)
            forced = [("rows", ("bwd_w2", "bwd_x"),
                       (S.BWD_Y2, S.BWD_GH, S.BWD_X))]
            if "fwd" in S.DESIGN:
                forced += [("fwd", ("fwd",), (S.FWD,)),
                           ("stats", ("stats",), (S.STATS,))]
            for key, passes, kinds in forced:
                for rows_ in (128, 64, 32):
                    S.DESIGN[key] = rows_
                    try:
                        row["designs"][f"{key}{rows_}"] = {
                            "tiles": [list(S._plan(kind, Bq, M, K,
                                                   feats.shape[2], mid, cout,
                                                   rows_)) for kind in kinds],
                            **{p: device(calls[p][0]) for p in passes}}
                    except (ValueError, RuntimeError) as e:
                        row["designs"][f"{key}{rows_}"] = {
                            "not_run": str(e)[:120]}
                    finally:
                        S.DESIGN[key] = 0
        rows.append(row)
        del w2_out, f, wt, calls, wargs, pargs, xargs
        torch.cuda.empty_cache()
    res["stages"] = rows

    def total(name, key="device_ms"):
        vals = [r[name][key] for r in rows]
        return None if any(v is None for v in vals) else sum(vals)

    res["sums"] = {name: {"device_ms": total(name),
                          "event_ms": total(name, "event_ms")}
                   for name in PASSES}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs="+", default=[REPO],
                    help="checkouts to time, in this order (default: this "
                         "one)")
    ap.add_argument("--designs", action="store_true",
                    help="also time the launch shapes a checkout offers")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=os.path.join(
        REPO, "build", "trainbn_timing.jsonl"))
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
