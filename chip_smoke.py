#!/usr/bin/env python3
"""Drive the PyTorch port (adaptpoint_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON object a line:

1. ``env``: the card (nvidia-smi name and power limit), torch and CUDA versions.
2. ``build``: the three CUDA sources of ``adaptpoint_tpu_torch/ops/csrc``
   compiled in parallel (one nvcc each), with the time it took.
3. ``kernel``: each kernel against its plain PyTorch version on the card at
   the shapes a B=32 PointNeXt-S forward gives it (FPS 1024 -> 512; the four
   SA stages for ball-group and fused SA), with errors, tolerances and
   CUDA-event times.
4. ``serve``: full-width ``cfgs/scanobjectnn/pointnext-s.yaml`` with seeded
   weights, exported unfused and fused at buckets 1,8,32 and served by the
   port's HTTP server; /predict with n = 1, 8, 32, 40 must match the same
   model's forward on a CPU copy, and the launch counters must show 1 FPS +
   4 ball-group (unfused) or 1 FPS + 4 fused-SA (fused) launches a forward.
5. ``throughput``: clouds/s and ms per B=32 forward on both routes.

Then the card's name and power limit as nvidia-smi prints them, the
``{"kernels": [...]}`` summary, and ``{"ok": true, "device": ...}`` as the
last line. Any failed phase raises and the exit code is not 0. Without a
CUDA device the script exits 2 and prints no result.
"""
from __future__ import annotations

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
            qidx = ops.fps.furthest_point_sample_cuda(xyz, m)
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
    from adaptpoint_tpu_torch.ops import ballgroup, fps, saeval

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
    emit("kernel_times", note="ms per B=32 forward; ball_group and sa_eval "
         "summed over the four SA stages", rows=rows)
    return rows


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
                want = {k: v * forwards for k, v in expect[fused].items()}
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
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    return {fused: sm for fused, (sm, _, _) in servers.items()}, launches


def phase_throughput(models, gen):
    """ms per forward by CUDA events, the host's enqueue time, and from
    torch.profiler the device's busy time (kernels only) and idle share."""
    import torch
    from torch.autograd import DeviceType
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
            kernels = [e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA]
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


def main() -> int:
    import torch
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
    rows = phase_kernels(gen)
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    models, launches = phase_serve(gen, out_dir)
    phase_throughput(models, gen)

    sources = {"fps": ("fps.cu", "adaptpoint_tpu/ops/pallas/fps.py:85"),
               "ball_group": ("ballgroup.cu",
                              "adaptpoint_tpu/ops/pallas/ballgroup.py:491"),
               "sa_eval": ("saeval.cu",
                           "adaptpoint_tpu/ops/pallas/saeval.py:252")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"adaptpoint_tpu_torch/ops/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
