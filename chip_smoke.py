#!/usr/bin/env python3
"""Drive the PyTorch port (adaptpoint_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON object a line:

1. ``env``: the card (nvidia-smi name and power limit), torch and CUDA versions.
2. ``build``: the CUDA sources of ``adaptpoint_tpu_torch/ops/csrc``
   compiled in parallel (one nvcc each), with the time it took.
3. ``kernel``: each kernel against its plain PyTorch version on the card at
   the shapes the B=32 PointNeXt-S forward and train step give it (FPS
   1024 -> 512 and 2048 -> 1200; the four SA stages for ball-group forward,
   backward and fused SA; the row gather and its scatter-add at the
   resampling shape and a feature shape), with errors, tolerances, bounds
   and CUDA-event times.
4. ``serve``: full-width ``cfgs/scanobjectnn/pointnext-s.yaml`` with seeded
   weights, exported unfused and fused at buckets 1,8,32 and served by the
   port's HTTP server; /predict with n = 1, 8, 32, 40 must match the same
   model's forward on a CPU copy, and the launch counters must show 1 FPS +
   4 ball-group (unfused) or 1 FPS + 4 fused-SA (fused) launches a forward.
5. ``throughput``: clouds/s and ms per B=32 forward on both routes.
6. ``train``: full-width PointNeXt-S classifier training through
   ``build_train_tools`` / ``make_train_step`` / ``train_one_epoch`` /
   ``validate`` on seeded (32, 2048, 4) batches: the first step against the
   same step on a CPU copy, the launches a step makes, a fixed batch's loss
   over 30 steps, the gradient through ``ops.fps``, and ms per step with
   the profiler's device-busy time.

Then the card's name and power limit as nvidia-smi prints them, the
``{"kernels": [...]}`` summary, and ``{"ok": true, "device": ...}`` as the
last line. Any failed phase raises and the exit code is not 0. Without a
CUDA device the script exits 2 and prints no result.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): bytes/s and op/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12

B, N0, K = 32, 1024, 32
# PointNeXt-S SA stages at N=1024: (N -> M, C in, mid, C out, radius)
STAGES = [(1024, 512, 32, 32, 64, 0.15), (512, 256, 64, 64, 128, 0.225),
          (256, 128, 128, 128, 256, 0.3375), (128, 64, 256, 256, 512, 0.50625)]
TOL_SA = 2e-2  # fused SA: |kernel - plain| <= TOL_SA * (1 + |plain|)
TOL_UNFUSED = (1e-3, 1e-4)  # (rtol, atol) serve logits, f32 route vs CPU
EPS32 = 2.0 ** -23  # f32 machine epsilon
# train phase: batches of (B, N_TRAIN, 4) resampled FPS N_TRAIN -> N_FPS, then
# a random N0 of those; labels in [0, CLASSES)
N_TRAIN, N_FPS, CLASSES, TRAIN_BATCHES, FIT_STEPS = 2048, 1200, 15, 8, 30
# first train step, card against the CPU copy: (rtol, atol)
# The first train step on the card (kernels) against two references; see
# compare() in phase_train. loss: relative; logits, buffers: (rtol, atol);
# grad_l2: each gradient tensor's relative 2-norm error; share: of each
# parameter tensor's entries within TOL_STEP_PARAMS + adam_slack.
# Against the plain versions on the card only the kernels differ: the
# scatter-adds' order. Against the float64 CPU copy the card's whole f32
# arithmetic differs: this network's backward loses digits in f32 (max-pool
# ties, batch statistics over 32 head rows), and the card's worst gradient
# tensor sits a relative 4.5e-3 from the float64 one.
TOL_STEP_PLAIN = {"loss": 1e-6, "logits": (1e-5, 1e-5), "grad_l2": 1e-4,
                  "buffers": (1e-5, 1e-6), "share": 0.98}
TOL_STEP_CPU = {"loss": 1e-5, "logits": (1e-4, 1e-4), "grad_l2": 2e-2,
                "buffers": (1e-4, 1e-6), "share": 0.9}
TOL_STEP_PARAMS = (1e-4, 1e-6)
# serve requests keep pool clouds whose CPU logits' top-2 gap is >= MARGIN
POOL, MARGIN = 256, 0.05
DEV = "cuda"


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, min_total_ms: float = 200.0) -> float:
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
    reps = int(min(50, max(3, min_total_ms / one)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def stage_inputs(gen):
    """Per-stage (xyz, qidx, feats) as the B=32 forward gives them: the
    unit-sphere cloud, FPS to 512 at stage 1, then FPS-ordered prefixes."""
    import torch
    from adaptpoint_tpu_torch import ops
    xyz = torch.randn((B, N0, 3), generator=gen, device=DEV)
    xyz = xyz / xyz.norm(dim=-1).amax(dim=1, keepdim=True)[..., None]
    out = []
    for i, (n, m, c, _, _, _) in enumerate(STAGES):
        if i == 0:
            qidx = ops.fpsample.furthest_point_sample_cuda(xyz, m)
        else:
            qidx = ops.fps_prefix_idx(B, m, DEV).contiguous()
        feats = torch.randn((B, n, c), generator=gen, device=DEV)
        out.append((xyz.contiguous(), qidx, feats))
        xyz = ops.index_points(xyz, qidx)
    return out


def scanned_points(xyz, qidx, radius):
    """Support points the ball query must look at: up to the K-th in-ball
    point, or all N when the ball holds fewer."""
    import torch
    from adaptpoint_tpu_torch.ops.geometry import index_points, radius_sq
    q = index_points(xyz, qidx)
    d = q[:, :, None, :] - xyz[:, None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    cum = torch.cumsum((d2 < radius_sq(radius)).int(), dim=-1)
    full = cum[..., -1] >= K
    kth = torch.argmax((cum >= K).int(), dim=-1) + 1
    return int(torch.where(full, kth, torch.full_like(kth, xyz.shape[1]))
               .sum())


def phase_kernels(gen):
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.ops import ballgroup, saeval
    from adaptpoint_tpu_torch.ops import fpsample as fps

    inputs = stage_inputs(gen)
    rows = {}

    # FPS at (32, 1024) -> 512
    xyz = inputs[0][0]
    got = fps.furthest_point_sample_cuda(xyz, 512)
    ref = fps.furthest_point_sample_plain(xyz, 512)
    torch.cuda.synchronize()
    mism = int((got != ref).sum())
    err = float((got.long() - ref.long()).abs().max())
    emit("kernel", name="fps", shape=[B, N0, 512], mismatches=mism,
         max_abs_err=err, tolerance="exact")
    if mism:
        raise AssertionError(f"FPS kernel disagrees at {mism} indices")
    ops_f = 511 * B * N0 * 10
    bytes_f = B * N0 * 12 + B * 512 * 4
    rows["fps"] = dict(
        ms=cuda_ms(lambda: fps.furthest_point_sample_cuda(xyz, 512)),
        plain_ms=cuda_ms(lambda: fps.furthest_point_sample_plain(xyz, 512),
                         50.0),
        bound_ms=1e3 * max(bytes_f / PEAK_BYTES, ops_f / PEAK_F32),
        bound_by="bytes" if bytes_f / PEAK_BYTES > ops_f / PEAK_F32
        else "operations", max_abs_err=err)

    bg = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0, t_b=0.0,
              t_o=0.0)
    sa = dict(bg)

    def add(acc, ms, plain_ms, t_b, t_o):
        """Sum one stage into a kernel's totals; returns the stage's row."""
        row = dict(ms=ms, plain_ms=plain_ms,
                   bound_ms=1e3 * max(t_b, t_o))
        for key in ("ms", "plain_ms", "bound_ms"):
            acc[key] += row[key]
        acc["t_b"] += t_b
        acc["t_o"] += t_o
        return row

    for i, ((n, m, c, mid, cout, r), (xyz, qidx, feats)) in enumerate(
            zip(STAGES, inputs)):
        # ball group, dp normalised as PointNeXt-S asks
        args = (r, K, xyz, qidx, feats, True, True)
        got = ballgroup.ball_group_cuda(*args)
        ref = ballgroup.ball_group_plain(*args)
        torch.cuda.synchronize()
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip(got, ref)]
        emit("kernel", name="ball_group", stage=[B, n, m, c, K],
             max_abs_err={"new_xyz": errs[0], "fi": errs[1], "dpfj": errs[2],
                          "idx": errs[3]}, tolerance="exact")
        if any(errs):
            raise AssertionError(f"ball-group kernel disagrees: {errs}")
        scanned = scanned_points(xyz, qidx, r)
        b_bytes = (B * n * 12 + B * n * c * 4 + B * m * 4 + B * m * 12
                   + B * m * c * 4 + B * K * m * (3 + c) * 4 + B * m * K * 4)
        b_ops = scanned * 9 + B * m * K * 6
        bg_row = add(bg, cuda_ms(lambda: ballgroup.ball_group_cuda(*args)),
                     cuda_ms(lambda: ballgroup.ball_group_plain(*args)),
                     b_bytes / PEAK_BYTES, b_ops / PEAK_F32)

        # fused SA with folded weights at this stage's widths
        w1 = torch.randn((3 + c, mid), generator=gen, device=DEV) \
            / (3 + c) ** 0.5
        b1 = torch.randn((mid,), generator=gen, device=DEV) * 0.1
        w2 = torch.randn((mid, cout), generator=gen, device=DEV) \
            / mid ** 0.5
        b2 = torch.randn((cout,), generator=gen, device=DEV) * 0.1
        sargs = (r, K, xyz, qidx, feats, w1, b1, w2, b2, True, True)
        got = saeval.sa_eval_cuda(*sargs)
        ref = saeval.sa_eval_plain(*sargs)
        torch.cuda.synchronize()
        e_xyz = float((got[0] - ref[0]).abs().max())
        e_fi = float((got[1] - ref[1]).abs().max())
        diff = (got[2] - ref[2]).abs()
        e_out = float(diff.max())
        rel = float((diff / (1.0 + ref[2].abs())).max())
        emit("kernel", name="sa_eval", stage=[B, n, m, c, mid, cout, K],
             max_abs_err={"new_xyz": e_xyz, "fi": e_fi, "out": e_out},
             max_scaled_err=rel, out_absmax=float(ref[2].abs().max()),
             tolerance=f"new_xyz, fi exact; |out - plain| <= {TOL_SA} * "
                       f"(1 + |plain|)")
        if e_xyz or e_fi or rel > TOL_SA or not torch.isfinite(got[2]).all():
            raise AssertionError(f"fused SA kernel disagrees: xyz {e_xyz} "
                                 f"fi {e_fi} out {e_out} scaled {rel}")
        s_bytes = (B * n * 12 + B * n * c * 4 + B * m * 4
                   + ((3 + c) * mid + mid * cout) * 2 + (mid + cout) * 4
                   + B * m * 12 + B * m * c * 4 + B * m * cout * 4)
        s_flops = 2 * B * m * K * ((3 + c) * mid + mid * cout)
        sa_row = add(sa, cuda_ms(lambda: saeval.sa_eval_cuda(*sargs)),
                     cuda_ms(lambda: saeval.sa_eval_plain(*sargs)),
                     s_bytes / PEAK_BYTES,
                     s_flops / PEAK_BF16 + scanned * 9 / PEAK_F32)
        sa["max_abs_err"] = max(sa["max_abs_err"], e_out)
        emit("stage_times", stage=i + 1, shape=[B, n, m, c, mid, cout, K],
             ball_group=bg_row, sa_eval=sa_row)
    for name, acc in (("ball_group", bg), ("sa_eval", sa)):
        acc["bound_by"] = "bytes" if acc.pop("t_b") > acc.pop("t_o") \
            else "operations"
        rows[name] = acc
    phase_train_kernels(gen, inputs, rows)
    emit("kernel_times", note="ms per B=32 forward or backward; ball_group, "
         "ball_group_bwd and sa_eval summed over the four SA stages; "
         "gather_rows and gather_rows_bwd at the resampling shape", rows=rows)
    return rows


def bound_row(t_bytes: float, t_ops: float) -> dict:
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations"}


def scatter_bound(counts, abs_sum):
    """Most that two f32 sums of the same ``n`` addends, taken in different
    orders, can differ: each is within ``(n - 1) * 2^-24 * sum|addend|`` of
    the true sum, so ``n * 2^-23 * sum|addend|`` bounds their difference."""
    return counts * EPS32 * abs_sum + 1e-30


def ball_group_bwd_bound(radius, idx, qidx, g_new, g_fi, g_dpfj, n):
    """Per-element bound on |kernel - plain| for the ball-group backward:
    both add the same f32 addends in another order (``scatter_bound``). The
    center's row also carries the inner sum over its K slots."""
    import torch
    from adaptpoint_tpu_torch.ops.ballgroup import ball_group_bwd_plain
    from adaptpoint_tpu_torch.ops.geometry import inv_radius
    Bq, K, M, _ = g_dpfj.shape
    one = torch.ones((Bq, K, M, 4), device=idx.device)
    counts = ball_group_bwd_plain(radius, idx, qidx, None, one[:, 0, :, :1],
                                  one, n, False, False)[1] + K
    s = inv_radius(radius)
    a_dp = g_dpfj[..., :3].abs() * s
    a_xyz, a_feats = ball_group_bwd_plain(
        radius, idx, qidx, g_new.abs() + a_dp.sum(dim=1), g_fi.abs(),
        torch.cat([a_dp, g_dpfj[..., 3:].abs()], -1), n, False, False)
    return scatter_bound(counts, a_xyz), scatter_bound(counts, a_feats)


def phase_train_kernels(gen, inputs, rows) -> None:
    """The kernels the train step adds, each against its plain version: FPS
    at the resampling shape, the ball-group backward at the four stage
    shapes (directly and through autograd), the row gather and its
    scatter-add. Adds their rows to ``rows``."""
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.ops import ballgroup, gather
    from adaptpoint_tpu_torch.ops import fpsample as fps

    # FPS at the resampling shape (32, 2048) -> 1200
    cloud = torch.randn((B, N_TRAIN, 3), generator=gen, device=DEV)
    cloud = cloud / cloud.norm(dim=-1).amax(dim=1, keepdim=True)[..., None]
    got = fps.furthest_point_sample_cuda(cloud, N_FPS)
    ref = fps.furthest_point_sample_plain(cloud, N_FPS)
    torch.cuda.synchronize()
    mism = int((got != ref).sum())
    emit("kernel", name="fps", shape=[B, N_TRAIN, N_FPS], mismatches=mism,
         tolerance="exact")
    if mism:
        raise AssertionError(f"FPS kernel disagrees at {mism} indices "
                             f"(2048 -> 1200)")
    ops_f = (N_FPS - 1) * B * N_TRAIN * 10
    bytes_f = B * N_TRAIN * 12 + B * N_FPS * 4
    rows["fps"]["resample_shape"] = dict(
        shape=[B, N_TRAIN, N_FPS],
        ms=cuda_ms(lambda: fps.furthest_point_sample_cuda(cloud, N_FPS)),
        plain_ms=cuda_ms(
            lambda: fps.furthest_point_sample_plain(cloud, N_FPS), 50.0),
        **bound_row(bytes_f / PEAK_BYTES, ops_f / PEAK_F32))

    # ball-group backward at the four stage shapes
    bwd = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, t_b=0.0, t_o=0.0)
    for i, ((n, m, c, _, _, r), (xyz, qidx, feats)) in enumerate(
            zip(STAGES, inputs)):
        idx = ballgroup.ball_group_cuda(r, K, xyz, qidx, feats, True, True)[3]
        g_new = torch.randn((B, m, 3), generator=gen, device=DEV)
        g_fi = torch.randn((B, m, c), generator=gen, device=DEV)
        g_dpfj = torch.randn((B, K, m, 3 + c), generator=gen, device=DEV)
        args = (r, idx, qidx, g_new, g_fi, g_dpfj, n, True, True)
        got = ballgroup.ball_group_bwd_cuda(*args)
        ref = ballgroup.ball_group_bwd_plain(*args)
        bounds = ball_group_bwd_bound(r, idx, qidx, g_new, g_fi, g_dpfj, n)
        # through autograd, with a strided g_dpfj and new_xyz left unused
        x_req = xyz.clone().requires_grad_()
        f_req = feats.clone().requires_grad_()
        out = ops.ball_group(r, K, x_req, qidx, f_req, True, True)
        strided = g_dpfj.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
        auto = torch.autograd.grad(out[:3], (x_req, f_req),
                                   (g_new, g_fi, strided))
        f_only = torch.autograd.grad(
            ops.ball_group(r, K, xyz, qidx, f_req, True, True)[1:3], f_req,
            (g_fi, g_dpfj))[0]
        torch.cuda.synchronize()
        errs, ok = {}, True
        for name, a, b_, bound in (("g_xyz", got[0], ref[0], bounds[0]),
                                   ("g_feats", got[1], ref[1], bounds[1]),
                                   ("autograd_g_xyz", auto[0], ref[0],
                                    bounds[0]),
                                   ("autograd_g_feats", auto[1], ref[1],
                                    bounds[1]),
                                   ("autograd_feats_only", f_only, ref[1],
                                    bounds[1])):
            d = (a - b_).abs()
            errs[name] = float(d.max())
            ok = ok and bool((d <= bound).all()) and bool(
                torch.isfinite(a).all())
        emit("kernel", name="ball_group_bwd", stage=[B, n, m, c, K],
             max_abs_err=errs, out_absmax=float(ref[1].abs().max()),
             bound_max=[float(b_.max()) for b_ in bounds],
             tolerance="|kernel - plain| <= n * 2^-23 * sum|addend| per "
                       "element (n addends meet there; atomic adds land in "
                       "no fixed order)")
        if not ok:
            raise AssertionError(f"ball-group backward disagrees: {errs}")
        b_bytes = (B * m * K * 4 + B * m * 4 + B * m * 12 + B * m * c * 4
                   + B * K * m * (3 + c) * 4 + B * n * (3 + c) * 4)
        b_ops = B * K * m * (3 + c) + B * K * m * 6 + B * m * (3 + c)
        row = dict(ms=cuda_ms(lambda: ballgroup.ball_group_bwd_cuda(*args)),
                   plain_ms=cuda_ms(
                       lambda: ballgroup.ball_group_bwd_plain(*args)),
                   bound_ms=1e3 * max(b_bytes / PEAK_BYTES, b_ops / PEAK_F32))
        bwd["ms"] += row["ms"]
        bwd["plain_ms"] += row["plain_ms"]
        bwd["t_b"] += b_bytes / PEAK_BYTES
        bwd["t_o"] += b_ops / PEAK_F32
        bwd["max_abs_err"] = max(bwd["max_abs_err"], errs["g_feats"],
                                 errs["g_xyz"])
        emit("stage_times", stage=i + 1, shape=[B, n, m, c, K],
             ball_group_bwd=row)
    bwd.update(bound_row(bwd.pop("t_b"), bwd.pop("t_o")))
    rows["ball_group_bwd"] = bwd

    # row gather and its scatter-add: the resampling shape (distinct rows)
    # and a feature shape whose indices repeat
    shapes = {"resample": (N_TRAIN, 4, N0, False), "feature": (512, 64, 256,
                                                                True)}
    for tag, (n, c, m, repeats) in shapes.items():
        pts = torch.randn((B, n, c), generator=gen, device=DEV)
        if repeats:
            idx = torch.randint(0, n // 4, (B, m), generator=gen, device=DEV,
                                dtype=torch.int32)
        else:
            idx = torch.argsort(torch.rand((B, n), generator=gen, device=DEV),
                                dim=1)[:, :m].int().contiguous()
        g = torch.randn((B, m, c), generator=gen, device=DEV)
        for dtype in (torch.float32, torch.bfloat16):
            p_t, g_t = pts.to(dtype), g.to(dtype)
            fwd = gather.gather_rows_cuda(p_t, idx)
            fwd_ref = gather.gather_rows_plain(p_t, idx)
            back = gather.gather_rows_bwd_cuda(g_t, idx, n)
            back_ref = gather.gather_rows_bwd_plain(g_t, idx, n)
            p_req = p_t.clone().requires_grad_()
            auto = torch.autograd.grad(ops.gather_rows(p_req, idx), p_req,
                                       g_t)[0]
            torch.cuda.synchronize()
            e_fwd = float((fwd.float() - fwd_ref.float()).abs().max())
            counts = gather.gather_rows_bwd_plain(torch.ones_like(g), idx, n)
            bound = scatter_bound(counts, gather.gather_rows_bwd_plain(
                g_t.float().abs(), idx, n))
            if dtype == torch.bfloat16:  # one bf16 rounding may flip
                bound = bound + back_ref.float().abs() * 2.0 ** -8
            if not repeats:
                bound = torch.zeros_like(bound)
            d_back = (back.float() - back_ref.float()).abs()
            d_auto = (auto.float() - back_ref.float()).abs()
            emit("kernel", name="gather_rows", shape=[B, n, c, m],
                 dtype=str(dtype), repeated_indices=repeats,
                 max_repeat=int(counts.max()),
                 max_abs_err={"forward": e_fwd, "backward":
                              float(d_back.max()),
                              "autograd": float(d_auto.max())},
                 tolerance="forward exact; backward exact for distinct "
                           "rows, else <= n * 2^-23 * sum|addend| per element "
                           "(+ one bf16 ulp for bf16)")
            if (e_fwd or not bool((d_back <= bound).all())
                    or not bool((d_auto <= bound).all())
                    or back.dtype != dtype or fwd.dtype != dtype):
                raise AssertionError(
                    f"row gather disagrees ({tag}, {dtype}): forward {e_fwd} "
                    f"backward {float(d_back.max())}")
            if dtype != torch.float32:
                continue
            flat = (idx.long() + torch.arange(B, device=DEV)[:, None] * n
                    ).reshape(-1)
            long_idx = idx.long()[..., None].expand(-1, -1, c)
            f_row = dict(
                shape=[B, n, c, m], max_abs_err=e_fwd,
                ms=cuda_ms(lambda: gather.gather_rows_cuda(pts, idx)),
                plain_ms=cuda_ms(lambda: gather.gather_rows_plain(pts, idx)),
                library_ms=cuda_ms(lambda: torch.gather(pts, 1, long_idx)),
                **bound_row((2 * B * m * c * 4 + B * m * 4) / PEAK_BYTES, 0.0))
            b_row = dict(
                shape=[B, n, c, m], max_abs_err=float(d_back.max()),
                ms=cuda_ms(lambda: gather.gather_rows_bwd_cuda(g, idx, n)),
                plain_ms=cuda_ms(
                    lambda: gather.gather_rows_bwd_plain(g, idx, n)),
                library_ms=cuda_ms(
                    lambda: torch.zeros((B * n, c), device=DEV).index_add_(
                        0, flat, g.reshape(-1, c))),
                **bound_row((B * m * c * 4 + B * m * 4 + B * n * c * 4)
                            / PEAK_BYTES, B * m * c / PEAK_F32))
            if tag == "resample":
                rows["gather_rows"], rows["gather_rows_bwd"] = f_row, b_row
            else:
                rows["gather_rows"]["feature_shape"] = f_row
                rows["gather_rows_bwd"]["feature_shape"] = b_row


def calibrate_bn(model, x):
    """Running statistics from one train-mode pass over ``x`` (momentum 1,
    dropout off so the pass is deterministic), so the random network's
    activations are unit scale and its BN folding is not the identity."""
    import torch
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm1d)]
    for bn in bns:
        bn.momentum = 1.0
    model.train()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.eval()
    with torch.no_grad():
        model(x[..., :3].contiguous(), x.contiguous())
    for bn in bns:
        bn.momentum = 0.1
    return model.eval()


def post(url: str, body: bytes) -> dict:
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.load(r)


def phase_serve(gen, out_dir):
    import numpy as np
    import torch
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.models import build_model_from_cfg
    from adaptpoint_tpu_torch.serving import (ServingModel,
                                              export_serving_artifact,
                                              preprocess_clouds)
    from adaptpoint_tpu_torch.serving.server import make_server
    from adaptpoint_tpu_torch.utils import EasyConfig

    cfg = EasyConfig()
    cfg.load(os.path.join(ROOT, "cfgs/scanobjectnn/pointnext-s.yaml"),
             recursive=True)
    model = build_model_from_cfg(cfg.model, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(0)

    def clouds(n):
        return preprocess_clouds(
            rng.standard_normal((n, N0, 3)).astype(np.float32)
            * np.array([1.0, 0.6, 0.3], np.float32))

    calibrate_bn(model, torch.from_numpy(clouds(B)).to(DEV))
    cpu = build_model_from_cfg(cfg.model, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})

    # The requests draw from a seeded pool and keep the clouds whose CPU
    # reference separates its top two classes by MARGIN on both routes: an
    # identical argmax is then a real check at the fused route's tolerance,
    # where a near-tie could flip on any reordering of the sums.
    requests = [1, 8, 32, 40]
    pool = clouds(POOL)
    refs = {}
    with torch.no_grad():
        for fused in (False, True):
            refs[fused] = np.concatenate([
                cpu(torch.from_numpy(c[..., :3]).contiguous(),
                    torch.from_numpy(c), fused_eval=fused).numpy()
                for c in np.split(pool, POOL // 32)])
    gap = np.minimum(*[np.diff(np.sort(r, -1)[:, -2:], axis=-1)[:, 0]
                       for r in refs.values()])
    keep = np.flatnonzero(gap >= MARGIN)
    emit("serve_pool", pool=POOL, margin=MARGIN, kept=int(keep.size),
         needed=sum(requests))
    if keep.size < sum(requests):
        raise AssertionError(f"only {keep.size} of {POOL} pool clouds have a "
                             f"top-2 gap >= {MARGIN}")

    expect = {False: {"fps": 1, "ball_group": 4, "sa_eval": 0},
              True: {"fps": 1, "ball_group": 0, "sa_eval": 4}}
    servers = {}
    ops.reset_launch_counts()  # the main path's run starts here
    for fused in (False, True):
        path = os.path.join(out_dir, "fused" if fused else "unfused")
        export_serving_artifact(model, path, num_points=N0, in_channels=4,
                                batch_sizes=(1, 8, 32), fused_eval=fused)
        sm = ServingModel(path)
        sm.warmup()
        srv = make_server(sm, port=0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        servers[fused] = (sm, srv, thread)
    try:
        for fused, (sm, srv, _) in servers.items():
            base = f"http://127.0.0.1:{srv.server_address[1]}"
            with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
                health = json.load(r)
            if not health["ok"] or health["fused_eval"] != fused:
                raise AssertionError(f"bad /healthz: {health}")
            start = 0
            for n in requests:
                sel = keep[start:start + n]
                start += n
                x = pool[sel]
                buf = io.BytesIO()
                np.save(buf, x)
                before = ops.launch_counts()
                t0 = time.perf_counter()
                reply = post(f"{base}/predict?logits=1", buf.getvalue())
                req_ms = 1e3 * (time.perf_counter() - t0)
                after = ops.launch_counts()
                forwards = -(-n // 32)
                delta = {k: after[k] - before[k] for k in after}
                want = {k: expect[fused].get(k, 0) * forwards for k in after}
                logits = np.asarray(reply["logits"], np.float32)
                ref = refs[fused][sel]
                err = float(np.abs(logits - ref).max())
                top2 = np.sort(ref, axis=-1)[:, -2:]
                gap = float((top2[:, 1] - top2[:, 0]).min())
                same = bool((np.asarray(reply["labels"])
                             == ref.argmax(-1)).all())
                if fused:
                    ok_tol = bool((np.abs(logits - ref)
                                   <= TOL_SA * (1 + np.abs(ref))).all())
                else:
                    ok_tol = bool(np.allclose(logits, ref, rtol=TOL_UNFUSED[0],
                                              atol=TOL_UNFUSED[1]))
                emit("serve", route="fused" if fused else "unfused", n=n,
                     request_ms=req_ms, launches=delta, expected=want,
                     max_abs_err_vs_cpu=err, argmax_equal=same,
                     min_top2_gap=gap,
                     logits_absmax=float(np.abs(ref).max()),
                     tolerance=(f"|d| <= {TOL_SA} * (1 + |ref|)" if fused else
                                f"rtol {TOL_UNFUSED[0]} atol "
                                f"{TOL_UNFUSED[1]}"))
                if delta != want:
                    raise AssertionError(f"launches {delta} != {want}")
                if logits.shape != (n, 15) or not np.isfinite(logits).all():
                    raise AssertionError(f"bad logits {logits.shape}")
                if not (same and ok_tol):
                    raise AssertionError(
                        f"serve logits disagree with the CPU copy: max err "
                        f"{err}, argmax equal {same}")
    finally:
        for _, srv, thread in servers.values():
            srv.shutdown()
            srv.server_close()
            thread.join()
    launches = ops.launch_counts()  # the main path's run ends here
    emit("serve_done", params=n_params, launches=launches)
    if min(launches[k] for k in ("fps", "ball_group", "sa_eval")) < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    return {fused: sm for fused, (sm, _, _) in servers.items()}, launches


def device_kernels(prof):
    """The profile's device-side entries that are work on the card: kernels,
    copies and memsets, without the annotations (an optimizer's ``step``)
    that span them and would count their time twice."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")]


def phase_throughput(models, gen):
    """ms per forward by CUDA events, the host's enqueue time, and from
    torch.profiler the device's busy time (kernels only) and idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for b in (1, 8, 32):
        x = torch.randn((b, N0, 3), generator=gen, device=DEV)
        x = x / x.norm(dim=-1).amax(dim=1, keepdim=True)[..., None]
        x = torch.cat([x, x[..., 1:2] - x[..., 1:2].amin(1, keepdim=True)], -1)
        for fused, sm in models.items():
            route = "fused" if fused else "unfused"
            ms = cuda_ms(lambda: sm.infer(x), 1000.0)
            reps = 10
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                sm.infer(x)
            enqueue_ms = 1e3 * (time.perf_counter() - t0) / reps
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    sm.infer(x)
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0) / reps
            kernels = device_kernels(prof)
            busy_ms = sum(e.self_device_time_total for e in kernels) \
                / 1e3 / reps
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
            row = {"ms_per_forward": ms, "clouds_per_s": b * 1e3 / ms,
                   "host_enqueue_ms": enqueue_ms,
                   "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
                   "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
                   "kernels_per_forward": sum(e.count for e in kernels) / reps,
                   "top_kernels_ms": [[e.key[:48], e.self_device_time_total
                                       / 1e3 / reps] for e in top]}
            out[f"{route}_b{b}"] = row
            emit("throughput", route=route, batch=b, **row)
    return out


@contextlib.contextmanager
def plain_ops():
    """Inside, every dispatching op of ``adaptpoint_tpu_torch.ops`` takes its
    plain PyTorch version whatever the tensor's device: the comparison's
    reference on the card. Nothing of the port does this."""
    from adaptpoint_tpu_torch import ops
    on_cuda = ops._on_cuda
    ops._on_cuda = lambda t: False
    try:
        yield
    finally:
        ops._on_cuda = on_cuda


def adam_slack(grad, lr: float, rtol: float, atol, eps: float = 1e-8):
    """How far the first Adam update ``lr * g / (|g| + eps)`` can move when
    ``g`` is only known to ``atol + rtol * |g|``: first order in that error,
    capped at ``2 lr``. Adam divides a gradient by its own size, so an entry
    whose gradient is as small as its tolerance moves by up to lr either way;
    for ordinary gradients this allowance is nothing."""
    g = grad.abs().double()
    delta = atol + rtol * g
    return lr * (eps * delta / (g + eps) ** 2).clamp(max=2.0)


def phase_train(gen):
    """Classifier training at full width through the entry points a user
    calls. Returns the launch counts of this path's run."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from adaptpoint_tpu_torch import ops
    from adaptpoint_tpu_torch.engine import (TrainState, build_train_tools,
                                             make_eval_step, make_train_step,
                                             train_one_epoch, validate)
    from adaptpoint_tpu_torch.models import build_model_from_cfg
    from adaptpoint_tpu_torch.ops.gather import gather_rows_bwd_plain
    from adaptpoint_tpu_torch.serving import preprocess_clouds
    from adaptpoint_tpu_torch.utils import EasyConfig

    cfg = EasyConfig()
    cfg.load(os.path.join(ROOT, "cfgs/scanobjectnn/pointnext-s.yaml"),
             recursive=True)
    lr = float(cfg.lr)
    rng = np.random.default_rng(1)

    # each class is a gaussian blob with its own axis lengths, each cloud a
    # jittered copy: the labels can be learnt, and the clouds of a batch
    # differ enough that the head's BatchNorm (statistics over B rows) does
    # not divide by a near-zero spread
    axes = rng.uniform(0.15, 1.0, (CLASSES, 3)).astype(np.float32)

    def batch(n=B, points=N_TRAIN):
        y = rng.integers(0, CLASSES, (n,)).astype(np.int64)
        scale = axes[y] * rng.uniform(0.8, 1.25, (n, 3)).astype(np.float32)
        x = preprocess_clouds(
            rng.standard_normal((n, points, 3)).astype(np.float32)
            * scale[:, None, :])
        return {"x": x, "y": y}

    batches = [batch() for _ in range(TRAIN_BATCHES)]
    model = build_model_from_cfg(cfg.model, seed=1)
    n_params = sum(p.numel() for p in model.parameters())

    def copy_of(device, dtype=torch.float32):
        twin = build_model_from_cfg(cfg.model, device=device).to(dtype)
        twin.load_state_dict({k: v.to(device) for k, v in
                              model.state_dict().items()})
        return twin

    # (a) the first step, taken three times from the same weights with the
    # same columns and dropout masks: on the card through the kernels (the
    # main path), on the card through the plain versions, and on a float64
    # CPU copy through the plain versions
    host_gen = torch.Generator().manual_seed(2)
    cols = torch.randperm(N_FPS, generator=host_gen)[:N0]
    masks = [torch.rand((B, w), generator=host_gen) >= 0.5
             for w in cfg.model.cls_args.mlps]
    first = {k: torch.from_numpy(v) for k, v in batches[0].items()}

    def first_step(net, device, dtype=torch.float32, step=None, st=None):
        if step is None:
            crit, opt, _ = build_train_tools(cfg, net)
            step, st = make_train_step(net, opt, crit, cfg), TrainState(net,
                                                                         opt)
        seen = {}
        hook = net.register_forward_hook(
            lambda _m, _i, out: seen.__setitem__("logits", out.detach()))
        _, loss_, preds_ = step(
            st,
            {"x": first["x"].to(device, dtype), "y": first["y"].to(device)},
            cols.to(device), lr, dropout_mask=[m.to(device) for m in masks])
        hook.remove()
        return {"loss": float(loss_), "preds": preds_.cpu(),
                "logits": seen["logits"].double().cpu(),
                "grads": {n: p.grad.double().cpu()
                          for n, p in net.named_parameters()},
                "params": {n: p.detach().double().cpu()
                           for n, p in net.named_parameters()},
                "buffers": {n: b_.double().cpu()
                            for n, b_ in net.named_buffers()}}

    plain_twin, cpu_twin = copy_of(DEV), copy_of("cpu", torch.float64)
    ops.reset_launch_counts()  # this path's run starts here
    criterion, optimizer, lr_fn = build_train_tools(cfg, model)
    train_step = make_train_step(model, optimizer, criterion, cfg)
    state = TrainState(model, optimizer)
    got = first_step(model, DEV, step=train_step, st=state)
    torch.cuda.synchronize()
    per_step = ops.launch_counts()
    with plain_ops():
        ref_plain = first_step(plain_twin, DEV)
    ref_cpu = first_step(cpu_twin, "cpu", torch.float64)
    if ops.launch_counts() != per_step:
        raise AssertionError("a plain-version step launched a kernel")
    del plain_twin, cpu_twin
    want = {"fps": 2, "gather_rows": 1, "gather_rows_bwd": 0,
            "ball_group": 4, "ball_group_bwd": 4, "sa_eval": 0}

    def compare(ref, tol):
        """Worst disagreements of ``got`` with ``ref`` and whether all are
        within ``tol``. A gradient tensor is held to a relative 2-norm: a
        max-pool hands its gradient to the row with the maximum, and where two
        rows tie to within f32 noise another row may win, so single entries
        can differ outright. After Adam every entry is within one step's
        reach (2 lr) of its counterpart, and ``share`` of each tensor's
        entries within the tight bound plus ``adam_slack``."""
        w = {"loss": abs(got["loss"] - ref["loss"]),
             "logits": float((got["logits"] - ref["logits"]).abs().max()),
             "grad_rel_l2": ("", 0.0), "param_share_outside": ("", 0.0),
             "param_abs": ("", 0.0), "buffer_abs": ("", 0.0)}
        good = (w["loss"] <= tol["loss"] * abs(ref["loss"])
                and bool(torch.allclose(got["logits"], ref["logits"],
                                        rtol=tol["logits"][0],
                                        atol=tol["logits"][1])))

        def note(key, name, value):
            if value > w[key][1]:
                w[key] = (name, value)

        # a gradient that cancels to nothing (a bias the next BatchNorm
        # removes) has no scale of its own: floor each tensor's scale at a
        # thousandth of the whole gradient's
        total = float(torch.cat([g_.flatten() for g_ in ref["grads"].values()]
                                ).norm())
        count = sum(g_.numel() for g_ in ref["grads"].values())
        for name, ref_g in ref["grads"].items():
            d = got["grads"][name] - ref_g
            l2 = float(d.norm() / max(float(ref_g.norm()), 1e-3 * total))
            note("grad_rel_l2", name, l2)
            ref_p = ref["params"][name]
            tight = TOL_STEP_PARAMS[1] + TOL_STEP_PARAMS[0] * ref_p.abs()
            dp = (got["params"][name] - ref_p).abs()
            slack = adam_slack(
                ref_g, lr, tol["grad_l2"], tol["grad_l2"] * max(
                    float(ref_g.abs().max()), total / count ** 0.5))
            outside = float((dp > tight + slack).double().mean())
            note("param_share_outside", name, outside)
            note("param_abs", name, float(dp.max()))
            good = (good and l2 <= tol["grad_l2"]
                    and outside <= 1 - tol["share"]
                    and bool((dp <= tight + 2.02 * lr).all()))
        for name, ref_b in ref["buffers"].items():
            if name.endswith("num_batches_tracked"):
                good = good and int(got["buffers"][name]) == int(ref_b) == 1
                continue
            note("buffer_abs", name,
                 float((got["buffers"][name] - ref_b).abs().max()))
            good = good and bool(torch.allclose(
                got["buffers"][name], ref_b, rtol=tol["buffers"][0],
                atol=tol["buffers"][1]))
        return w, good

    w_plain, ok_plain = compare(ref_plain, TOL_STEP_PLAIN)
    w_cpu, ok_cpu = compare(ref_cpu, TOL_STEP_CPU)
    emit("train_first_step", params=n_params, loss=got["loss"],
         plain_loss=ref_plain["loss"], cpu_f64_loss=ref_cpu["loss"],
         logits_absmax=float(ref_cpu["logits"].abs().max()),
         preds_equal=bool((got["preds"] == ref_cpu["preds"]).all()),
         against_plain_versions_on_the_card=w_plain,
         against_float64_cpu_copy=w_cpu,
         launches=per_step, expected=want,
         tolerance={"against_plain_versions_on_the_card": TOL_STEP_PLAIN,
                    "against_float64_cpu_copy": TOL_STEP_CPU,
                    "params": f"all within rtol {TOL_STEP_PARAMS[0]} atol "
                              f"{TOL_STEP_PARAMS[1]} + 2 lr; `share` of each "
                              f"tensor within rtol/atol + adam_slack"})
    if per_step != want:
        raise AssertionError(f"launches in one train step {per_step} != "
                             f"{want}")
    if not (ok_plain and ok_cpu and np.isfinite(got["loss"])):
        raise AssertionError(f"the first train step disagrees: with the "
                             f"plain versions {w_plain}, with the CPU copy "
                             f"{w_cpu}")

    # the epoch loop and both eval routes
    dev_gen = torch.Generator(device=DEV).manual_seed(3)
    before = ops.launch_counts()
    t0 = time.perf_counter()
    state, mean_loss, macc, oa, _, cm = train_one_epoch(
        train_step, state, batches, dev_gen, lr_fn(0), cfg)
    epoch_s = time.perf_counter() - t0
    got = {k: v - before[k] for k, v in ops.launch_counts().items()}
    want_epoch = {k: v * TRAIN_BATCHES for k, v in want.items()}
    emit("train_epoch", steps=TRAIN_BATCHES, mean_loss=mean_loss, oa=oa,
         macc=macc, counted=int(cm.value.sum()), seconds=epoch_s,
         launches=got, expected=want_epoch)
    if got != want_epoch or int(cm.value.sum()) != TRAIN_BATCHES * B \
            or not np.isfinite(mean_loss):
        raise AssertionError(f"train_one_epoch: launches {got}, counted "
                             f"{int(cm.value.sum())}, loss {mean_loss}")
    val = [batch(64, N0), dict(batch(64, N0), n_valid=40)]
    for fused in (False, True):
        before = ops.launch_counts()
        macc, oa, _, cm = validate(make_eval_step(model, cfg, fused), state,
                                   val, cfg)
        got = {k: v - before[k] for k, v in ops.launch_counts().items()
               if v - before[k]}
        want_val = {"fps": 2, "sa_eval" if fused else "ball_group": 8}
        emit("validate", route="fused" if fused else "unfused", oa=oa,
             macc=macc, counted=int(cm.value.sum()), launches=got,
             expected=want_val)
        if got != want_val or int(cm.value.sum()) != 64 + 40:
            raise AssertionError(f"validate: launches {got}, counted "
                                 f"{int(cm.value.sum())}")

    # (b) one fixed batch for FIT_STEPS steps. SmoothCrossEntropy cannot go
    # below the entropy of its smoothed target, so the loss that must halve is
    # the loss above that floor.
    eps_ls = float(cfg.criterion_args.label_smoothing)
    floor = -((1 - eps_ls) * np.log(1 - eps_ls)
              + eps_ls * np.log(eps_ls / (CLASSES - 1)))
    fixed = {k: torch.from_numpy(v).to(DEV) for k, v in batches[1].items()}
    losses = []
    for _ in range(FIT_STEPS):
        state, loss, _ = train_step(state, fixed, dev_gen, lr)
        losses.append(loss)
    losses = torch.stack(losses).cpu().tolist()
    emit("train_fit", steps=FIT_STEPS, first_loss=losses[0],
         last_loss=losses[-1], loss_floor=floor,
         excess_ratio=(losses[-1] - floor) / (losses[0] - floor),
         losses=[round(v, 4) for v in losses])
    if not (np.isfinite(losses).all()
            and losses[-1] - floor < 0.5 * (losses[0] - floor)):
        raise AssertionError(f"the loss on a fixed batch did not halve its "
                             f"excess over the floor {floor}: {losses}")

    # (d) the gather's backward kernel: the classifier step never asks for
    # it (a batch carries no gradient), ops.fps on a tensor that does
    pts = fixed["x"].clone().requires_grad_()
    g = torch.randn((B, N_FPS, 4), generator=gen, device=DEV)
    before = ops.launch_counts()
    out = ops.fps(pts, N_FPS)
    (g_pts,) = torch.autograd.grad(out, pts, g)
    got = {k: v - before[k] for k, v in ops.launch_counts().items()
           if v - before[k]}
    with torch.no_grad():
        idx = ops.furthest_point_sample(pts[..., :3], N_FPS)
    ref = gather_rows_bwd_plain(g, idx, N_TRAIN)
    err = float((g_pts - ref).abs().max())
    emit("train_fps_grad", shape=[B, N_TRAIN, 4, N_FPS], launches=got,
         max_abs_err=err, tolerance="exact (FPS rows are distinct)")
    if got != {"fps": 1, "gather_rows": 1, "gather_rows_bwd": 1} or err:
        raise AssertionError(f"gradient through ops.fps: launches {got}, "
                             f"max err {err}")
    launches = ops.launch_counts()  # this path's run ends here
    emit("train_done", launches=launches)

    # ms per train step (CUDA events after a warm-up), then the profiler
    dev_batches = [{k: torch.from_numpy(v).to(DEV) for k, v in b.items()}
                   for b in batches]
    it = [0]

    def one_step():
        train_step(state, dev_batches[it[0] % TRAIN_BATCHES], dev_gen, lr)
        it[0] += 1

    ms = cuda_ms(one_step, 1000.0)
    reps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        one_step()
    enqueue_ms = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            one_step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    emit("train_throughput", batch=B, points=N_TRAIN, ms_per_step=ms,
         clouds_per_s=B * 1e3 / ms, host_enqueue_ms=enqueue_ms,
         profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
         kernels_per_step=sum(e.count for e in kernels) / reps,
         top_kernels_ms=[[e.key[:48], e.self_device_time_total / 1e3 / reps]
                         for e in top])
    return launches


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="kernels,serve,train",
                    help="comma-separated subset of kernels,serve,train for "
                         "a partial run, which prints no final result "
                         "(default: all)")
    phases = set(ap.parse_args(argv).phases.split(","))
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from adaptpoint_tpu_torch import resolve_device
    from adaptpoint_tpu_torch.ops import _build

    resolve_device()  # TF32 off
    smi = nvidia_smi()
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), python=sys.version.split()[0])

    t0 = time.perf_counter()
    _build.build_all()
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in _build.build_logs.items()}
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    gen = torch.Generator(device=DEV).manual_seed(0)
    rows = phase_kernels(gen) if "kernels" in phases else None
    serve_launches = train_launches = None
    if "serve" in phases:
        out_dir = os.path.join(ROOT, "build", "chip_smoke")
        models, serve_launches = phase_serve(gen, out_dir)
        phase_throughput(models, gen)
        del models
    if "train" in phases:
        train_launches = phase_train(gen)
    emit("done", seconds=time.perf_counter() - t_start)
    if None in (rows, serve_launches, train_launches):
        print(f"partial run ({sorted(phases)}): no final result",
              file=sys.stderr)
        return 0

    pallas = "adaptpoint_tpu/ops/pallas/"
    sources = {"fps": ("fps.cu", pallas + "fps.py:85"),
               "ball_group": ("ballgroup.cu", pallas + "ballgroup.py:491"),
               "sa_eval": ("saeval.cu", pallas + "saeval.py:252"),
               "ball_group_bwd": ("ballgroup_bwd.cu",
                                  pallas + "ballgroup.py:547"),
               "gather_rows": ("gather.cu", pallas + "gather.py:110"),
               "gather_rows_bwd": ("gather.cu", pallas + "gather.py:144")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = rows[name]
        by_path = {"serve": serve_launches[name],
                   "train": train_launches[name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"adaptpoint_tpu_torch/ops/csrc/{src}",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms")})
        for extra in ("resample_shape", "feature_shape"):
            if extra in r:
                kernels[-1][extra] = r[extra]
        if train_launches[name] < 1:
            raise AssertionError(f"{name} never launched on the train path")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
