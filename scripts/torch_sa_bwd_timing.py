#!/usr/bin/env python3
"""Time the fused SA kernels (kernel rows 3, 5 and 6) and the row gather with
its scatter-add (rows 14 and 15) of one or more checkouts of the PyTorch
port on one NVIDIA GPU, in turns.

    python3 scripts/torch_sa_bwd_timing.py                # this checkout
    python3 scripts/torch_sa_bwd_timing.py --roots OLD . . OLD

Each root is a directory that holds ``adaptpoint_tpu_torch``; each runs in a
child process of its own, which builds that checkout's kernels and prints
one JSON line. Inputs are seeded and the same for every root:

- rows 5 and 6 (``sa_train_cuda``, ``sa_train_bwd_cuda`` without weight
  gradients) at the GAN step's fake pass, the frozen classifier's four
  stages from N=2048 at B=32, K=32, on clouds with half their points at the
  origin; row 3 (``sa_eval_cuda``) at the same stages on whole clouds (the
  real pass) and at the four serving stages (N=1024, B=32, the fused
  serving forward); beside each forward time its bound (the larger of the
  bytes over the memory rate and the products at the stage's unpadded
  widths over the bf16 tensor rate plus the ball query's distances, 9
  operations a point it must scan, over the f32 rate), with the parts;
- row 14 (``gather_rows_cuda``) at the train step's resampling shape and
  the GAN step's twelve gathers (random indices into each source), with
  ``torch.gather`` beside it; row 15 (``gather_rows_bwd_cuda``) at the same
  shapes with ``index_add_`` into a zeroed tensor beside it.

For each: the device time of the call alone (``torch.profiler``, all of its
kernels and memsets, per call), the host's enqueue time per call (a host
clock around calls that do not wait for the card) and the mean of a
CUDA-event loop. Row 6 is also held against its plain version on the card
(relative 2-norm of each gradient, with and without the weight gradients, as
``chip_smoke.py`` holds it), row 14 bit for bit against ``torch.gather`` in
both types (also at odd widths) and, per stage, the scatter's contention:
the most slots that name one point; and row 6 on a small wide stage (C =
512, 128 centers) for six seeds against the plain version and a float64
copy, and beside each seed the h_pre entries within the f32 reordering
bound of zero (whose mask another sum order can flip), the entries whose
mask does differ (the plain version's against float64; where the checkout
reports it, the kernel's against both) and the distance from the plain
version on the kernel's own mask. Where the checkout's row-6 wrapper
can force a launch shape, also: row 6's grouped layout forced at the GAN
stages (timed beside GH whole, held within 1e-5 of it), and row 6 at the
grouped layout's own shapes (C = 256, mid 512, K = 48 with weight
gradients; C = 512, mid 1024, K = 64 with and without) for six seeds,
each gradient's distance from the plain version on its own mask and on
the kernel's, with the mask counts above. Each kernel's
registers and spill bytes from the build, and the
tensor-core instructions of rows 3-6 (``cuobjdump -sass``, where the toolkit
has it: both kernels' conv1 lowers to HMMA.16816.F32.BF16). The card's name and power limit (``nvidia-smi``) lead the output;
``--out`` gets the same lines.

Compare two checkouts only inside one run: hosts and clocks differ between
machines. Needs a GPU; exits with 2 without one.
"""
from __future__ import annotations

import argparse
import collections
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, K, N_GAN, FAKE_DROPPED = 32, 32, 2048, 0.5
# the frozen classifier's stages in a GAN step: (N -> M, C in, mid, C out,
# radius)
STAGES = [(2048, 1024, 32, 32, 64, 0.15), (1024, 512, 64, 64, 128, 0.225),
          (512, 256, 128, 128, 256, 0.3375), (256, 128, 256, 256, 512, 0.50625)]
# PointNeXt-S's stages in the fused serving forward (N = 1024)
SERVE_STAGES = [(1024, 512, 32, 32, 64, 0.15), (512, 256, 64, 64, 128, 0.225),
                (256, 128, 128, 128, 256, 0.3375),
                (128, 64, 256, 256, 512, 0.50625)]
# row gathers: (case, launches a GAN step, N, C, M); the resampling gather
# is the train step's (1 a step)
GATHERS = [("resample", 0, 2048, 4, 1024), ("anchors", 2, 2048, 3, 4),
           ("head kNN xyz", 1, 128, 3, 96), ("head pooling", 1, 128, 1024, 96),
           ("decode 1024 xyz", 1, 1024, 3, 6144),
           ("decode 1024 features", 1, 1024, 128, 6144),
           ("decode 512 xyz", 1, 512, 3, 3072),
           ("decode 512 features", 1, 512, 256, 3072),
           ("decode 256 xyz", 1, 256, 3, 1536),
           ("decode 256 features", 1, 256, 512, 1536),
           ("decode 128 xyz", 1, 128, 3, 768),
           ("decode 128 features", 1, 128, 1024, 768)]
# the scatter-adds a GAN step runs (the gathers whose source has a gradient)
SCATTERS = ("head pooling", "decode 1024 features", "decode 512 features",
            "decode 256 features", "decode 128 features")
TOL_SA_BWD = 1e-3  # chip_smoke.py's bound on each gradient's 2-norm error
TOL_GROUPED = 1e-5  # chip_smoke.py's bound on the grouped layout vs GH whole
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12  # H100 SXM, dense


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


def device_ms(fn, reps: int = 20) -> dict:
    """Device time per call by ``torch.profiler``: the sum over all the
    call's kernels and memsets, and each kernel's share. A profile that
    recorded no device activity (it happens) is taken again; after three
    such, the time is None (not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        parts = {e.key.replace("(anonymous namespace)::", "")
                 .split("(")[0][-48:]: e.self_device_time_total / 1e3 / reps
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA}
        if sum(parts.values()) > 0:
            return {"ms": sum(parts.values()), "parts": parts}
    return {"ms": None, "parts": {}}


def total(values):
    """The sum, or None where a value was not measured."""
    values = list(values)
    return None if any(v is None for v in values) else sum(values)


def timings(fn, min_total_ms: float = 100.0) -> dict:
    dev = device_ms(fn)
    return {"device_ms": dev["ms"], "host_us": host_us(fn),
            "event_ms": cuda_ms(fn, min_total_ms), "kernels": dev["parts"]}


def ptxas_rows(log: str) -> dict:
    names = re.findall(r"entry function '(\w+)'", log)
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores", log)
    return {n[-60:]: [int(r), int(sp)] for n, r, sp in zip(names, regs, spills)}


def hmma_kinds(path) -> dict:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True).stdout
    return dict(collections.Counter(re.findall(r"HMMA\.[0-9A-Z.]+", out)))


def scanned_points(xyz, qidx, radius) -> int:
    """Support points the ball query must look at: up to the K-th in-ball
    point, or all N when the ball holds fewer (chip_smoke.py's count)."""
    import torch
    q = torch.gather(xyz, 1, qidx.long()[..., None].expand(-1, -1, 3))
    d = q[:, :, None, :] - xyz[:, None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    cum = torch.cumsum((d2 < torch.tensor(radius, dtype=torch.float32) ** 2)
                       .int(), dim=-1)
    full = cum[..., -1] >= K
    kth = torch.argmax((cum >= K).int(), dim=-1) + 1
    return int(torch.where(full, kth, torch.full_like(kth, xyz.shape[1]))
               .sum())


def r16(x: int) -> int:
    return (x + 15) // 16 * 16


def fwd_bound(stage, xyz, qidx) -> dict:
    """The fused SA forward's bound at one stage (ms) and its parts: the
    products at the unpadded widths (and, for comparison, at the kernel's
    padded ones) over the bf16 rate, the ball query's distances over the
    f32 rate, the bytes over the memory rate."""
    n, m, c, mid, cout, r = stage
    rows = B * m * K
    t_mma = 2 * rows * ((3 + c) * mid + mid * cout) / PEAK_BF16
    t_pad = 2 * rows * (r16(3 + c) * r16(mid) + r16(mid) * r16(cout)) \
        / PEAK_BF16
    t_scan = scanned_points(xyz, qidx, r) * 9 / PEAK_F32
    t_bytes = (B * n * 12 + B * n * c * 4 + B * m * 4
               + ((3 + c) * mid + mid * cout) * 2 + (mid + cout) * 4
               + B * m * 12 + B * m * c * 4 + B * m * cout * 4) / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_bytes, t_mma + t_scan),
            "products_ms": 1e3 * t_mma, "products_padded_ms": 1e3 * t_pad,
            "ball_query_ms": 1e3 * t_scan, "bytes_ms": 1e3 * t_bytes}


def clouds(gen, dropped: float, stages=STAGES):
    """(B, N, 3) clouds in the unit ball, ``dropped`` of their points at the
    origin, and each stage's (xyz, qidx, feats) as the classifier's forward
    gives them: FPS to half at stage 1, then FPS-order prefixes."""
    import torch
    from adaptpoint_tpu_torch import ops
    xyz = torch.randn((B, stages[0][0], 3), generator=gen, device="cuda")
    xyz = xyz / xyz.norm(dim=-1).amax(dim=1, keepdim=True)[..., None]
    if dropped:
        xyz = xyz * (torch.rand(xyz.shape[:2], generator=gen, device="cuda")
                     >= dropped)[..., None]
    out = []
    for i, (n, m, c, _, _, _) in enumerate(stages):
        if i == 0:
            qidx = ops.fpsample.furthest_point_sample_cuda(xyz, m).int()
        else:
            qidx = (torch.arange(m, device="cuda", dtype=torch.int32)[None]
                    .expand(B, -1).contiguous())
        feats = torch.randn((B, n, c), generator=gen, device="cuda")
        out.append((xyz.contiguous(), qidx.contiguous(), feats))
        xyz = torch.gather(xyz, 1, qidx.long()[..., None].expand(-1, -1, 3))
    return out


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def small_stage(saeval, gen, b, n, m, c, mid, cout):
    """Row 6's inputs on a small stage: ``b`` clouds of ``n`` points in the
    unit ball, half of them at the origin, ``m`` random centers each, and
    the stage's weights, packed too."""
    import torch
    xyz = torch.randn((b, n, 3), generator=gen, device="cuda")
    xyz = xyz / xyz.norm(dim=-1).amax(dim=1, keepdim=True)[..., None]
    xyz = (xyz * (torch.rand((b, n), generator=gen, device="cuda")
                  >= FAKE_DROPPED)[..., None]).contiguous()
    qidx = torch.stack([torch.randperm(n, generator=gen, device="cuda")[:m]
                        for _ in range(b)]).int().contiguous()
    feats = torch.randn((b, n, c), generator=gen, device="cuda")
    w1 = torch.randn((3 + c, mid), generator=gen, device="cuda") \
        / (3 + c) ** 0.5
    b1 = torch.randn((mid,), generator=gen, device="cuda") * 0.1
    w2 = torch.randn((mid, cout), generator=gen, device="cuda") / mid ** 0.5
    b2 = torch.randn((cout,), generator=gen, device="cuda") * 0.1
    return xyz, qidx, feats, (w1, b1, w2, b2), saeval.pack_weights(
        w1, b1, w2, b2)


def wide_stage_seeds(saeval, seeds: int = 6) -> list:
    """Row 6 on a small wide stage (C = 512, 2 clouds of 64 centers, half
    their points at the origin) for several seeds: its relative 2-norm
    distance from the plain version and from a float64 copy of it, and the
    plain version's own distance from float64, each on the forward
    kernel's neighbours and winners. Few centers make single bf16 rounding
    and mask flips show."""
    import torch
    b, n, m, c, mid, cout, k, r = 2, 512, 64, 512, 512, 1024, 32, 0.4
    rows = []
    for seed in range(seeds):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        xyz, qidx, feats, (w1, b1, w2, b2), packed = small_stage(
            saeval, gen, b, n, m, c, mid, cout)
        _, _, _, arg, idx = saeval.sa_train_cuda(r, k, xyz, qidx, feats,
                                                 packed, True, True)
        cots = [torch.randn(shape, generator=gen, device="cuda")
                for shape in ((b, m, 3), (b, m, c), (b, m, cout))]
        # the kernel's own ReLU mask, where the checkout's wrapper reports it
        relu = None
        if "relu" in inspect.signature(saeval.sa_train_bwd_cuda).parameters:
            relu = torch.zeros((b, m, k, packed.w1.shape[1]),
                               dtype=torch.uint8, device="cuda")
            got = saeval.sa_train_bwd_cuda(r, xyz, qidx, feats, packed, idx,
                                           arg, *cots, True, True, relu=relu)
        else:
            got = saeval.sa_train_bwd_cuda(r, xyz, qidx, feats, packed, idx,
                                           arg, *cots, True, True)
        ref = saeval.sa_train_bwd_plain(r, xyz, qidx, feats, w1, b1, w2, b2,
                                        idx, arg, *cots, True, True)
        ref64 = saeval.sa_train_bwd_plain(
            r, xyz.double(), qidx, feats.double(), w1.double(), b1.double(),
            w2.double(), b2.double(), idx, arg, *[t.double() for t in cots],
            True, True)
        rows.append({"seed": seed,
                     "g_xyz": rel_l2(got[0], ref[0]),
                     "g_feats": rel_l2(got[1], ref[1]),
                     "g_xyz_vs_f64": rel_l2(got[0], ref64[0]),
                     "plain_g_xyz_vs_f64": rel_l2(ref[0], ref64[0]),
                     **near_zero_h_pre(saeval, r, k, xyz, qidx, feats, w1,
                                       b1, idx, arg, relu)})
        if relu is not None:
            refk = saeval.sa_train_bwd_plain(r, xyz, qidx, feats, w1, b1, w2,
                                             b2, idx, arg, *cots, True, True,
                                             relu=relu)
            rows[-1]["g_xyz_on_kernel_mask"] = rel_l2(got[0], refk[0])
            rows[-1]["g_feats_on_kernel_mask"] = rel_l2(got[1], refk[1])
    return rows


# the grouped layout's shapes (chip_smoke.py SA_BWD_SHAPES): (N, M, C, mid,
# cout, K, radius, with weight gradients), 2 clouds of 64 centers
GROUPED_SHAPES = [(1024, 64, 256, 512, 512, 48, 0.4, True),
                  (1024, 64, 512, 1024, 1024, 64, 0.4, False),
                  (1024, 64, 512, 1024, 1024, 64, 0.4, True)]


def grouped_stage_seeds(saeval, seeds: int = 6) -> list:
    """Row 6 at GROUPED_SHAPES for several seeds (each seed's draw as
    :func:`wide_stage_seeds` makes it): the largest relative 2-norm
    distance of a gradient from the plain version on the plain version's
    own ReLU mask and on the kernel's, and the mask counts of
    :func:`near_zero_h_pre`."""
    import torch
    b, out = 2, []
    for n, m, c, mid, cout, k, r, pg in GROUPED_SHAPES:
        for seed in range(seeds):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            xyz, qidx, feats, w, packed = small_stage(saeval, gen, b, n, m,
                                                      c, mid, cout)
            _, _, _, arg, idx = saeval.sa_train_cuda(r, k, xyz, qidx, feats,
                                                     packed, True, True)
            cots = [torch.randn(shape, generator=gen, device="cuda")
                    for shape in ((b, m, 3), (b, m, c), (b, m, cout))]
            tl = saeval._bwd_tiling(k, *packed.w1.shape, packed.w2.shape[1],
                                    c, pg)
            relu = torch.zeros((b, m, k, packed.w1.shape[1]),
                               dtype=torch.uint8, device="cuda")
            got = saeval.sa_train_bwd_cuda(r, xyz, qidx, feats, packed, idx,
                                           arg, *cots, True, True, pg,
                                           relu=relu)
            got = got[:2] + (got[2] or ())
            row = {"shape": [b, n, m, c, mid, cout, k], "weights": pg,
                   "seed": seed, "tiling": list(tl)}
            for tag, mask in (("own_mask", None), ("kernel_mask", relu)):
                ref = saeval.sa_train_bwd_plain(
                    r, xyz, qidx, feats, *w, idx, arg, *cots, True, True, pg,
                    relu=mask)
                ref = ref[:2] + (ref[2] or ())
                row[tag] = max(rel_l2(x, y) for x, y in zip(got, ref))
            row.update(near_zero_h_pre(saeval, r, k, xyz, qidx, feats, w[0],
                                       w[1], idx, arg, relu))
            out.append(row)
    return out


def grouped_forced(saeval, tm: int, k: int, packed, c: int, pg: bool):
    """The grouped layout forced at ``tm`` centers a block (one block an
    SM), its group the widest of 32-256 hidden columns that fits: the
    shape ``chip_smoke.py`` holds against GH whole."""
    wp, midp = packed.w1.shape
    coutp = packed.w2.shape[1]
    ng = max(w for w in (32, 64, 128, 256)
             if w <= saeval._pass_cols(saeval._bwd_rows(tm, k))
             and saeval._bwd_smem_bytes(tm, k, wp, midp, coutp, c, pg, w)
             <= saeval._SMEM_LIMIT)
    return saeval.BwdTiling(tm, ng, 1)


def near_zero_h_pre(saeval, r, k, xyz, qidx, feats, w1, b1, idx, arg,
                    relu=None) -> dict:
    """The h_pre entries whose ReLU mask two f32 sum orders can disagree
    on: |h_pre| (in float64) within the reordering bound of its n = 3 + C + 1
    addends, n 2^-23 sum|addend| (the products bf16(gg) bf16(w1) are exact
    in f32, b1 the last addend). All of them, and those in rows that win at
    least one output (the only rows whose g_h is not zero). Then the entries
    whose mask does differ: the plain f32 version's against float64 and,
    with the kernel's mask ``relu``, the kernel's against the plain
    version's and against float64 (in winning rows)."""
    import torch
    _, _, _, gg = saeval._grouped_rows(r, k, xyz, qidx, feats, True, True,
                                       idx)
    g64 = gg.double()
    w64 = w1.to(torch.bfloat16).double()
    h = torch.einsum("bmkc,cd->bmkd", g64, w64) + b1.double()
    absum = torch.einsum("bmkc,cd->bmkd", g64.abs(), w64.abs()) \
        + b1.double().abs()
    near = h.abs() <= (gg.shape[-1] + 1) * 2.0 ** -23 * absum
    won = torch.zeros(idx.shape, dtype=torch.bool, device=idx.device)
    won.scatter_(2, arg.long(), True)
    won = won[..., None]
    plain = torch.matmul(gg, w1.to(torch.bfloat16).float()) + b1 > 0
    out = {"h_pre_entries": h.numel(),
           "h_pre_near_zero": int(near.sum()),
           "h_pre_near_zero_in_winning_rows": int((near & won).sum()),
           "plain_mask_flips_vs_f64_in_winning_rows":
               int(((plain != (h > 0)) & won).sum())}
    if relu is not None:
        mine = relu[..., :h.shape[-1]] != 0
        out["kernel_mask_flips_vs_plain_in_winning_rows"] = int(
            ((mine != plain) & won).sum())
        out["kernel_mask_flips_vs_f64_in_winning_rows"] = int(
            ((mine != (h > 0)) & won).sum())
    return out


def child(root: str) -> dict:
    import torch
    sys.path.insert(0, os.path.abspath(root))
    from adaptpoint_tpu_torch.ops import _build, gather, saeval

    names = ["fps", "saeval", "sa_train_bwd", "gather"]
    for n in names[1:]:  # built here, so that the build log reports them
        _build._lib_path(n).unlink(missing_ok=True)
    _build.build_all(names)
    res = {"root": os.path.abspath(root), "device": torch.cuda.get_device_name(0),
           "registers_spills": {n: ptxas_rows(_build.build_logs.get(n, ""))
                                for n in names[1:]},
           "hmma": {n: hmma_kinds(_build._lib_path(n))
                    for n in ("saeval", "sa_train_bwd")}}
    # the grouped layout, where the checkout's wrapper can force it
    grouped = "tiling" in inspect.signature(
        saeval.sa_train_bwd_cuda).parameters
    gen = torch.Generator(device="cuda").manual_seed(0)
    real, fake = clouds(gen, 0.0), clouds(gen, FAKE_DROPPED)
    stages = []
    for (n, m, c, mid, cout, r), (xr, qr, fr), (xyz, qidx, feats) in zip(
            STAGES, real, fake):
        w1 = torch.randn((3 + c, mid), generator=gen, device="cuda") \
            / (3 + c) ** 0.5
        b1 = torch.randn((mid,), generator=gen, device="cuda") * 0.1
        w2 = torch.randn((mid, cout), generator=gen, device="cuda") / mid ** 0.5
        b2 = torch.randn((cout,), generator=gen, device="cuda") * 0.1
        packed = saeval.pack_weights(w1, b1, w2, b2)
        g_new = torch.randn((B, m, 3), generator=gen, device="cuda")
        g_fi = torch.randn((B, m, c), generator=gen, device="cuda")
        g_out = torch.randn((B, m, cout), generator=gen, device="cuda")
        fargs = (r, K, xyz, qidx, feats)
        _, _, _, arg, idx = saeval.sa_train_cuda(*fargs, packed, True, True)
        bargs = (r, xyz, qidx, feats)
        back = saeval.sa_train_bwd_cuda(*bargs, packed, idx, arg, g_new,
                                        g_fi, g_out, True, True)
        ref = saeval.sa_train_bwd_plain(*bargs, w1, b1, w2, b2, idx, arg,
                                        g_new, g_fi, g_out, True, True)
        errs = {"g_xyz": rel_l2(back[0], ref[0]),
                "g_feats": rel_l2(back[1], ref[1])}
        forced = None
        if grouped:  # the grouped layout forced, against GH whole
            tl = saeval._bwd_tiling(K, *packed.w1.shape, packed.w2.shape[1],
                                    c, False)
            forced = grouped_forced(saeval, tl.tm, K, packed, c, False)
            got = saeval.sa_train_bwd_cuda(*bargs, packed, idx, arg, g_new,
                                           g_fi, g_out, True, True,
                                           tiling=forced)
            errs["grouped_vs_whole"] = max(rel_l2(x, y) for x, y in
                                           zip(got[:2], back[:2]))
            if errs["grouped_vs_whole"] > TOL_GROUPED:
                raise AssertionError(f"the grouped layout disagrees with GH "
                                     f"whole at stage ({n}, {m}, {c}): "
                                     f"{errs['grouped_vs_whole']}")
        back = saeval.sa_train_bwd_cuda(*bargs, packed, idx, arg, g_new,
                                        g_fi, g_out, True, True, True)
        ref = saeval.sa_train_bwd_plain(*bargs, w1, b1, w2, b2, idx, arg,
                                        g_new, g_fi, g_out, True, True, True)
        for name, x, y in zip(("g_w1", "g_b1", "g_w2", "g_b2"), back[2],
                              ref[2]):
            errs[name] = rel_l2(x, y)
        if max(errs.values()) > TOL_SA_BWD:
            raise AssertionError(f"row 6 disagrees with its plain version at "
                                 f"stage ({n}, {m}, {c}): {errs}")
        counts = torch.zeros((B, n), device="cuda").scatter_add_(
            1, idx.reshape(B, -1).long(), torch.ones(idx.reshape(B, -1).shape,
                                                     device="cuda"))
        rows = B * m * K
        bwd_flops = 2 * rows * ((3 + c) * mid + cout * mid + mid * (3 + c))
        stage = {
            "shape": [B, n, m, c, mid, cout, K], "grad_rel_l2": errs,
            "bound_fwd_real": fwd_bound((n, m, c, mid, cout, r), xr, qr),
            "bound_fwd_fake": fwd_bound((n, m, c, mid, cout, r), xyz, qidx),
            "most_slots_on_one_point": int(counts.max()),
            "bound_ms_bwd": 1e3 * max(
                bwd_flops / PEAK_BF16,
                (2 * (B * n * 12 + B * n * c * 4) + B * m * (4 + K * 4 + 12
                 + c * 4 + cout * 5)) / PEAK_BYTES),
            "sa_train_bwd": timings(lambda: saeval.sa_train_bwd_cuda(
                *bargs, packed, idx, arg, g_new, g_fi, g_out, True, True)),
            "sa_train_bwd_grouped": None if forced is None else {
                "tiling": list(forced), **timings(
                    lambda: saeval.sa_train_bwd_cuda(
                        *bargs, packed, idx, arg, g_new, g_fi, g_out, True,
                        True, tiling=forced))},
            "sa_train": timings(lambda: saeval.sa_train_cuda(
                *fargs, packed, True, True)),
            "sa_eval": timings(lambda: saeval.sa_eval_cuda(
                r, K, xr, qr, fr, packed=packed, relative=True,
                normalize_dp=True))}
        stages.append(stage)
        del back, ref
        torch.cuda.empty_cache()
    res["stages"] = stages
    res["sums_device_ms"] = {k: total(s[k]["device_ms"] for s in stages)
                             for k in ("sa_train_bwd", "sa_train", "sa_eval")}
    if grouped:
        res["sums_device_ms"]["sa_train_bwd_grouped"] = total(
            s["sa_train_bwd_grouped"]["device_ms"] for s in stages)
    res["sums_bound_ms"] = {
        k: sum(s[k]["bound_ms"] for s in stages)
        for k in ("bound_fwd_real", "bound_fwd_fake")}
    # row 3 at the serving stages (whole clouds from N = 1024)
    serving = []
    for (n, m, c, mid, cout, r), (xr, qr, fr) in zip(
            SERVE_STAGES, clouds(gen, 0.0, SERVE_STAGES)):
        w = [torch.randn((3 + c, mid), generator=gen, device="cuda")
             / (3 + c) ** 0.5,
             torch.randn((mid,), generator=gen, device="cuda") * 0.1,
             torch.randn((mid, cout), generator=gen, device="cuda")
             / mid ** 0.5,
             torch.randn((cout,), generator=gen, device="cuda") * 0.1]
        packed = saeval.pack_weights(*w)
        serving.append({
            "shape": [B, n, m, c, mid, cout, K],
            "bound": fwd_bound((n, m, c, mid, cout, r), xr, qr),
            "sa_eval": timings(lambda: saeval.sa_eval_cuda(
                r, K, xr, qr, fr, packed=packed, relative=True,
                normalize_dp=True))})
    res["serving_stages"] = serving
    res["serving_sums"] = {
        "sa_eval_device_ms": total(s["sa_eval"]["device_ms"]
                                   for s in serving),
        "bound_ms": sum(s["bound"]["bound_ms"] for s in serving)}
    res["wide_stage_seeds"] = wide_stage_seeds(saeval)
    if grouped:
        res["grouped_stage_seeds"] = grouped_stage_seeds(saeval)

    # odd widths and both types: every access width and lane group
    for c in (1, 2, 3, 5, 8, 12, 33, 64, 130, 1024):
        for dtype in (torch.float32, torch.bfloat16):
            pts = torch.randn((3, 77, c), generator=gen, device="cuda").to(
                dtype)
            idx = torch.randint(0, 77, (3, 301), generator=gen,
                                device="cuda", dtype=torch.int32)
            got = gather.gather_rows_cuda(pts, idx)
            if not torch.equal(got, torch.gather(
                    pts, 1, idx.long()[..., None].expand(-1, -1, c))):
                raise AssertionError(f"row 14 is not exact at C={c} {dtype}")
    rows14 = []
    for case, launches, n, c, m in GATHERS:
        pts = torch.randn((B, n, c), generator=gen, device="cuda")
        if case == "resample":
            idx = torch.stack([torch.randperm(n, generator=gen, device="cuda")
                               [:m] for _ in range(B)]).int()
        else:
            idx = torch.randint(0, n, (B, m), generator=gen, device="cuda",
                                dtype=torch.int32)
        long_idx = idx.long()[..., None].expand(-1, -1, c)
        row = {"case": case, "shape": [B, n, c, m],
               "launches_a_gan_step": launches,
               "bound_ms": 1e3 * (2 * B * m * c * 4 + B * m * 4) / PEAK_BYTES}
        for dtype in (torch.float32, torch.bfloat16):
            p_t = pts.to(dtype)
            got = gather.gather_rows_cuda(p_t, idx)
            if not torch.equal(got, torch.gather(p_t, 1, long_idx)):
                raise AssertionError(f"row 14 is not exact at {case}, {dtype}")
        row["gather_rows"] = timings(lambda: gather.gather_rows_cuda(pts, idx),
                                     30.0)
        row["torch_gather"] = timings(lambda: torch.gather(pts, 1, long_idx),
                                      30.0)
        if case in SCATTERS or case == "resample":
            g = torch.randn((B, m, c), generator=gen, device="cuda")
            flat = (idx.long() + torch.arange(B, device="cuda")[:, None] * n
                    ).reshape(-1)
            row["gather_rows_bwd"] = timings(
                lambda: gather.gather_rows_bwd_cuda(g, idx, n), 30.0)
            row["index_add"] = timings(
                lambda: torch.zeros((B * n, c), device="cuda").index_add_(
                    0, flat, g.reshape(-1, c)), 30.0)
        rows14.append(row)
    res["gathers"] = rows14
    gan = [r for r in rows14 if r["launches_a_gan_step"]]
    res["gan_step_sums_device_ms"] = {
        key: total(r["launches_a_gan_step"] * r[key]["device_ms"]
                   if r[key]["device_ms"] is not None else None for r in gan)
        for key in ("gather_rows", "torch_gather")}
    res["gan_step_sums_device_ms"].update({
        key: total(r[key]["device_ms"] for r in gan if r["case"] in SCATTERS)
        for key in ("gather_rows_bwd", "index_add")})
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs="+", default=[REPO],
                    help="checkouts to time, in this order (default: this "
                         "one)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=os.path.join(
        REPO, "build", "sa_bwd_timing.jsonl"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lines = [json.dumps({"nvidia_smi": smi})]
    print(lines[0], flush=True)
    for root in args.roots:
        got = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", root], capture_output=True,
                             text=True)
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
