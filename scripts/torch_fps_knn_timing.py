#!/usr/bin/env python3
"""Time the FPS kernel (kernel row 1) and the exact kNN kernel (row 11) of one
or more checkouts of the PyTorch port on one NVIDIA GPU, in turns.

    python3 scripts/torch_fps_knn_timing.py                # this checkout
    python3 scripts/torch_fps_knn_timing.py --roots OLD . . OLD

Each root is a directory that holds ``adaptpoint_tpu_torch``; each runs in a
child process of its own, which builds that checkout's two kernels and
prints one JSON line. Inputs are seeded and the same for every root:

- FPS (``furthest_point_sample_cuda``) at the main paths' shapes, B = 32:
  1024 -> 512 (the serving forward), 2048 -> 1200 (the train step's
  resampling) and 2048 -> 1024 (each of the GAN step's two calls), on
  clouds in the unit ball; and at B = 8: 16384 -> 4096 (the sphere
  protocol's size), 24000 -> 6000 (the S3DIS crop) and 32768 -> 8192, each
  on the instance the checkout's ``fps_tiling`` picks (a checkout whose
  kernel refuses an N reports that shape as refused);
- kNN (``knn_idx_cuda``) at the GAN step's five calls, B = 32, C = 3: k = 3
  at the four FP-decode levels (support N = 1024, 512, 256, 128 from the FPS
  half of a 2048-point cloud and its prefixes, queries the level above) and
  k = 24 for the deformation head (N = 128, 4 queries), with
  ``torch.topk(torch.cdist(q, x), k, largest=False)`` beside it: a stand-in
  that computes other arithmetic and breaks ties its own way, not a library
  call for the same function.

- the tiled kNN instance (``knn_idx_cuda`` past ``knn_max_points(C)``) at
  DGCNN's three feature-space calls on ScanObjectNN, B = 32, N = M = 1024,
  k = 20, C = 64, 64, 128, on seeded leaky-ReLU'd features (the graph's
  support is its queries), with the same stand-in beside it and the
  operation bound, each call held index for index against the plain
  version. A root's kernel is the one its checkout builds: a parent
  checkout gives the parent's kernel.

``--parts`` picks which of ``fps``, ``knn`` and ``knn_tiled`` run (all by
default). ``--unchecked ROOT ...`` times the tiled calls of further roots
without holding their outputs, after the checked roots: copies of the tree
with one piece of the tiled kernel taken out or changed, as
``scripts/knn_tiled_variants.py`` makes them.

With ``--designs`` each root also times, at B = 8 on two kinds of cloud --
uniform rooms (4 x 4 x 3 m filled as ``SyntheticScene`` fills them) and
rooms of surfaces (``scripts/surface_rooms.py``: floor, ceiling, four walls
and three tables with 3 mm of jitter), both made from ``--seed`` in this
process and handed to every root alike:

- at 24000 -> 6000 and 32768 -> 8192: the instance the checkout's
  ``fps_tiling`` picks, the four-block cluster instance where the checkout
  keeps it beside the pruned kernel (``fpsample.FPS_CLUSTER_INSTANCE``,
  forced through ``tiling=``), the pruned kernel's set-up alone (npoint =
  1: the sort and the buckets' boxes), and, where the checkout's chain
  kernel takes N / 4 points, the chain kernel over a quarter of the cloud
  (N / 4 points, as many steps): a floor for a four-block cluster whose
  blocks exchange their winners without a cluster barrier, since each of
  its blocks does that work and then the exchange;
- at 4096, 8192 and 16384 -> N / 4 (the sizes ``fps_tiling`` decides
  between): the checkout's pick, and the pruned kernel forced where the
  pick is the chain kernel. The one-block chain instances past 4096 points
  that the pruned kernel replaced are timed from a checkout that has them:
  ``--roots OLD . . OLD``;

each held index for index against the plain version.

With ``--steps`` each root also times PointNeXt-B's S3DIS train step and
eval forward (``cfgs/s3dis/pointnext-b.yaml``, seeded weights, B = 8 crops
of 24000 points) on the same two kinds of room, aligned as
``PointCloudXYZAlign`` aligns them, with raw 0-255 colours and heights as
features: CUDA-event ms and the profiler's device-busy ms. A parent root
gives the step on its own FPS instance.

For each: the device time of the call alone (``torch.profiler``, per call),
the host's enqueue time per call (a host clock around calls that do not wait
for the card) and the mean of a CUDA-event loop; for FPS also ns a step
(the event time over npoint - 1). Every kernel result is held against its
plain version on the card, index for index. Each kernel's registers and
spill bytes from the build. The card's name and power limit (``nvidia-smi``)
lead the output; ``--out`` gets the same lines.

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
# (B, N, npoint, launches on the paths): serving forward, train step, GAN
# step, then B = 8 clouds past 4096 points (the pruned kernel)
FPS_SHAPES = [(B, 1024, 512, "1 / fused serving forward"),
              (B, 2048, 1200, "1 / train step"),
              (B, 2048, 1024, "2 / GAN step"),
              (8, 16384, 4096, "none (the sphere protocol's size)"),
              (8, 24000, 6000, "1 / S3DIS train step and eval forward"),
              (8, 32768, 8192, "none")]
# --designs: (N, npoint) past 16384 points and the sizes the chooser
# decides between, B = 8
DESIGN_SHAPES = [(24000, 6000), (32768, 8192)]
CHOOSER_SHAPES = [(4096, 1024), (8192, 2048), (16384, 4096)]
CLOUD_KINDS = ("uniform room", "surface room")
# --steps: points a crop (the S3DIS cfg's voxel_max)
STEP_POINTS = 24000
# the GAN step's kNN calls: (support N, queries M, k, caller)
KNN_SHAPES = [(1024, 2048, 3, "FP decode"), (512, 1024, 3, "FP decode"),
              (256, 512, 3, "FP decode"), (128, 256, 3, "FP decode"),
              (128, 4, 24, "deformation head")]
# DGCNN's feature-space kNN calls (cfgs/scanobjectnn/dgcnn.yaml): C of
# each, B = 32, N = M = 1024, k = 20
DGCNN_C, DGCNN_N, DGCNN_K = (64, 64, 128), 1024, 20
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12  # H100 SXM, dense


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


def device_ms(fn, reps: int = 20):
    """Device time per call by ``torch.profiler`` (all of the call's
    kernels); None (not measured) if three profiles recorded no device
    activity."""
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
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / reps
    return None


def timings(fn, min_total_ms: float = 100.0) -> dict:
    return {"device_ms": device_ms(fn), "host_us": host_us(fn),
            "event_ms": cuda_ms(fn, min_total_ms)}


def ptxas_rows(log: str) -> dict:
    names = re.findall(r"entry function '(\w+)'", log)
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores", log)
    return {n[-60:]: [int(r), int(sp)] for n, r, sp in zip(names, regs, spills)}


def unit_clouds(gen, n: int, b: int = B):
    import torch
    xyz = torch.randn((b, n, 3), generator=gen, device="cuda")
    return (xyz / xyz.norm(dim=-1).amax(dim=1, keepdim=True)[..., None]
            ).contiguous()


def fps_rows(fps, gen) -> list:
    import torch
    rows = []
    for b, n, npoint, launches in FPS_SHAPES:
        xyz = unit_clouds(gen, n, b)
        try:
            tiling = list(fps.fps_tiling(n))
        except ValueError as e:
            rows.append({"shape": [b, n, npoint], "refused": str(e)})
            continue
        got = fps.furthest_point_sample_cuda(xyz, npoint)
        ref = fps.furthest_point_sample_plain(xyz, npoint)
        if not torch.equal(got, ref):
            raise AssertionError(f"FPS disagrees with its plain version at "
                                 f"{n} -> {npoint}: "
                                 f"{int((got != ref).sum())} indices")
        row = {"shape": [b, n, npoint], "launches": launches,
               "tiling": tiling,
               "bound_ms": 1e3 * max((npoint - 1) * b * n * 10 / PEAK_F32,
                                     (b * n * 12 + b * npoint * 4)
                                     / PEAK_BYTES),
               "fps": timings(lambda: fps.furthest_point_sample_cuda(
                   xyz, npoint))}
        row["ns_a_step"] = row["fps"]["event_ms"] * 1e6 / (npoint - 1)
        rows.append(row)
    return rows


def design_clouds(seed: int) -> dict:
    """{(kind, N): (8, N, 3) float32} for --designs, from ``seed``: uniform
    rooms and rooms of surfaces."""
    import numpy as np
    sys.path.insert(0, REPO)
    from scripts.surface_rooms import surface_room
    rng = np.random.default_rng(seed)
    out = {}
    for n, _ in DESIGN_SHAPES + CHOOSER_SHAPES:
        out[("uniform room", n)] = (rng.random((8, n, 3)) * [4, 4, 3]
                                    ).astype(np.float32)
        out[("surface room", n)] = np.stack(
            [surface_room(n, rng)[0] for _ in range(8)])
    return out


def fps_design_rows(fps, clouds_path: str) -> list:
    """The checkout's instances on both kinds of cloud (see the module's
    note)."""
    import numpy as np
    import torch
    clouds = np.load(clouds_path)
    rows = []

    def run(kind, n, npoint, name, xyz, **kw):
        ref = fps.furthest_point_sample_plain(xyz, npoint)
        got = fps.furthest_point_sample_cuda(xyz, npoint, **kw)
        if not torch.equal(got, ref):
            raise AssertionError(f"FPS {name} disagrees with its plain "
                                 f"version at {n} -> {npoint} ({kind}): "
                                 f"{int((got != ref).sum())} indices")
        t = timings(lambda: fps.furthest_point_sample_cuda(xyz, npoint, **kw))
        rows.append({"cloud": kind, "shape": [8, n, npoint], "design": name,
                     "fps": t, "ns_a_step": t["event_ms"] * 1e6
                     / (npoint - 1) if npoint > 1 else None})

    def pick(n):
        tl = fps.fps_tiling(n)
        return tl, getattr(tl, "kind", "chain")

    cluster = getattr(fps, "FPS_CLUSTER_INSTANCE", None)
    for kind in CLOUD_KINDS:
        for n, npoint in DESIGN_SHAPES:
            xyz = torch.from_numpy(clouds[f"{kind}/{n}"]).cuda().contiguous()
            tl, what = pick(n)
            run(kind, n, npoint, f"pick {tuple(tl)}", xyz)
            if what == "pruned":
                run(kind, n, 1, "pruned, set-up alone", xyz)
            if cluster is not None and cluster[0] * cluster[1] >= n:
                run(kind, n, npoint, f"cluster instance {tuple(cluster)}",
                    xyz, tiling=tuple(cluster))
            tl, what = pick(n // 4)
            if what == "chain":
                run(kind, n // 4, n // 4, "chain on one block over N / 4 "
                    "points (floor of a cluster without its barrier)",
                    xyz[:, :n // 4].contiguous())
        for n, npoint in CHOOSER_SHAPES:
            xyz = torch.from_numpy(clouds[f"{kind}/{n}"]).cuda().contiguous()
            tl, what = pick(n)
            run(kind, n, npoint, f"pick {tuple(tl)}", xyz)
            if what == "chain" and any(getattr(t, "kind", "") == "pruned"
                                       for t in fps.FPS_INSTANCES):
                run(kind, n, npoint, "pruned, forced", xyz,
                    tiling=(1024, 0, "pruned"))
    return rows


def step_rooms(seed: int) -> dict:
    """{kind/key: array} for --steps, from ``seed``: B = 8 rooms of 24000
    points of each kind, x and y centred and the floor at 0, features
    (r, g, b, height): SyntheticScene's colours (its label's, 0 or 255) on
    the uniform rooms, raw colours on the surfaces; labels the height's
    quarter."""
    import numpy as np
    sys.path.insert(0, REPO)
    from scripts.surface_rooms import surface_room
    rng = np.random.default_rng(seed)
    b, n = 8, STEP_POINTS
    out = {}
    for kind in CLOUD_KINDS:
        if kind == "uniform room":
            pos = rng.random((b, n, 3)).astype(np.float32) * [4, 4, 3]
            y = np.clip((pos[..., 2] / 3.0 * 4).astype(np.int64), 0, 3)
            rgb = np.eye(4)[y][..., :3] * 255
        else:
            rooms = [surface_room(n, rng) for _ in range(b)]
            pos = np.stack([r[0] for r in rooms])
            rgb = np.stack([r[1] for r in rooms])
        pos[..., :2] -= pos[..., :2].mean(1, keepdims=True)
        pos[..., 2] -= pos[..., 2].min(1, keepdims=True)
        y = np.clip((pos[..., 2] / 3.0 * 4).astype(np.int64), 0, 3)
        out[f"{kind}/pos"] = pos.astype(np.float32)
        out[f"{kind}/x"] = np.concatenate([rgb, pos[..., 2:3]],
                                          -1).astype(np.float32)
        out[f"{kind}/y"] = y
    return out


def step_rows(rooms_path: str) -> list:
    """PointNeXt-B's train step and eval forward on the rooms of
    ``rooms_path``, this checkout's port (see the module's note)."""
    import numpy as np
    import torch
    from adaptpoint_tpu_torch.engine import TrainState, build_train_tools
    from adaptpoint_tpu_torch.engine.seg_main import make_seg_train_step
    from adaptpoint_tpu_torch.models import build_model_from_cfg
    from adaptpoint_tpu_torch.ops import fpsample
    from adaptpoint_tpu_torch.utils import EasyConfig
    cfg = EasyConfig()
    cfg.load(os.path.join(REPO, "cfgs", "s3dis", "pointnext-b.yaml"),
             recursive=True)
    cfg.model.in_channels = cfg.model.encoder_args.in_channels
    model = build_model_from_cfg(cfg.model, seed=1)
    crit, opt, _ = build_train_tools(cfg, model)
    step = make_seg_train_step(model, opt, crit, cfg)
    st = TrainState(model, opt)
    gen = torch.Generator(device="cuda").manual_seed(3)
    lr = float(cfg.lr)
    rooms = np.load(rooms_path)
    rows = []
    for kind in CLOUD_KINDS:
        batch = {k: torch.from_numpy(rooms[f"{kind}/{k}"]).cuda().contiguous()
                 for k in ("pos", "x", "y")}

        def train():
            step(st, batch, lr, generator=gen)

        def fwd():
            with torch.no_grad():
                model(batch["pos"], batch["x"])

        for what, fn in (("train step", train), ("eval forward", fwd)):
            model.train(what == "train step")
            rows.append({"cloud": kind, "what": what,
                         "shape": list(batch["pos"].shape),
                         "fps_tiling": list(fpsample.fps_tiling(
                             batch["pos"].shape[1])),
                         "event_ms": cuda_ms(fn, 1000.0),
                         "device_busy_ms": device_ms(fn, reps=5)})
    return rows


def knn_rows(fps, knn, gen) -> list:
    import torch
    cloud = unit_clouds(gen, 2048)
    order = fps.furthest_point_sample_cuda(cloud, 1024)
    half = torch.gather(cloud, 1, order.long()[..., None].expand(-1, -1, 3))
    levels = [cloud, half.contiguous()] + [half[:, :m].contiguous()
                                          for m in (512, 256, 128)]
    rows = []
    for i, (n, m, k, caller) in enumerate(KNN_SHAPES):
        support = levels[i + 1] if i < 4 else levels[4]
        query = levels[i] if i < 4 else cloud[:, :m].contiguous()
        assert support.shape[1] == n and query.shape[1] == m
        got = knn.knn_idx_cuda(k, support, query)
        ref = knn.knn_idx_plain(k, support, query)
        if not torch.equal(got, ref):
            raise AssertionError(f"kNN disagrees with its plain version at "
                                 f"N={n} M={m} k={k}: "
                                 f"{int((got != ref).sum())} indices")
        row = {"shape": [B, n, m, 3, k], "caller": caller,
               "bound_ms": 1e3 * max(B * m * n * 9 / PEAK_F32,
                                     (B * (n + m) * 12 + B * m * k * 4)
                                     / PEAK_BYTES),
               "knn": timings(lambda: knn.knn_idx_cuda(k, support, query),
                              30.0),
               "stand_in_cdist_topk": timings(lambda: torch.topk(
                   torch.cdist(query, support), k, dim=-1, largest=False),
                   30.0)}
        if hasattr(knn, "knn_variant"):
            row["variant"] = list(knn.knn_variant(k, n, 3))
        rows.append(row)
    return rows


def knn_tiled_rows(knn, gen, checked: bool = True) -> list:
    """DGCNN's three tiled calls (see the module's note)."""
    import torch
    rows = []
    n = m = DGCNN_N
    k = DGCNN_K
    for c in DGCNN_C:
        feats = torch.nn.functional.leaky_relu(
            torch.randn((B, n, c), generator=gen, device="cuda"), 0.2)
        if checked:
            got = knn.knn_idx_cuda(k, feats, feats)
            ref = knn.knn_idx_plain(k, feats, feats)
            if not torch.equal(got, ref):
                raise AssertionError(f"tiled kNN disagrees with its plain "
                                     f"version at C={c}: "
                                     f"{int((got != ref).sum())} indices")
        rows.append({
            "shape": [B, n, m, c, k], "checked": checked,
            "variant": list(knn.knn_variant(k, n, c)),
            # a pair: C products and C - 1 sums of q.x, |q|^2 + |x|^2, the
            # doubling, the difference; each point's norm once (2C - 1)
            "bound_ms": 1e3 * max(B * (m * n * (2 * c + 2)
                                       + (n + m) * (2 * c - 1)) / PEAK_F32,
                                  (2 * B * n * c * 4 + B * m * k * 4)
                                  / PEAK_BYTES),
            "knn": timings(lambda: knn.knn_idx_cuda(k, feats, feats)),
            "stand_in_cdist_topk": timings(lambda: torch.topk(
                torch.cdist(feats, feats), k, dim=-1, largest=False))})
    return rows


def total(values):
    values = list(values)
    return None if any(v is None for v in values) else sum(values)


def child(root: str, clouds: str = "", rooms: str = "",
          parts: str = "fps,knn,knn_tiled", checked: bool = True) -> dict:
    import torch
    sys.path.insert(0, os.path.abspath(root))
    from adaptpoint_tpu_torch.ops import _build, fpsample, knn

    parts = set(parts.split(","))
    names = ["fps", "knn"]
    for n in names:  # built here, so that the build log reports them
        _build._lib_path(n).unlink(missing_ok=True)
    _build.build_all(names)
    if rooms:  # every kernel of the step, one nvcc a source in parallel
        _build.build_all()
    res = {"root": os.path.abspath(root),
           "device": torch.cuda.get_device_name(0),
           "registers_spills": {n: ptxas_rows(_build.build_logs.get(n, ""))
                                for n in names}}
    if "knn_tiled" in parts:  # a generator of its own: the others' inputs
        res["knn_tiled"] = knn_tiled_rows(  # stay as they were
            knn, torch.Generator(device="cuda").manual_seed(0), checked)
        res["knn_tiled_sums"] = {
            f"{key}_{what}": total(r[key][what] for r in res["knn_tiled"])
            for key in ("knn", "stand_in_cdist_topk")
            for what in ("device_ms", "event_ms")}
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "fps" in parts:
        res["fps"] = fps_rows(fpsample, gen)
    if clouds:
        res["fps_designs"] = fps_design_rows(fpsample, clouds)
    if rooms:
        res["seg_steps"] = step_rows(rooms)
    if "knn" not in parts or "fps" not in parts:
        return res
    res["knn"] = knn_rows(fpsample, knn, gen)
    gan = res["fps"][2]
    res["fps_gan_step_device_ms"] = (None if gan["fps"]["device_ms"] is None
                                     else 2 * gan["fps"]["device_ms"])
    res["knn_gan_step_sums"] = {
        key: total(r[key]["device_ms"] for r in res["knn"])
        for key in ("knn", "stand_in_cdist_topk")}
    res["knn_gan_step_sums"]["knn_event_ms"] = sum(
        r["knn"]["event_ms"] for r in res["knn"])
    res["knn_gan_step_sums"]["bound_ms"] = sum(r["bound_ms"]
                                               for r in res["knn"])
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs="+", default=[REPO],
                    help="checkouts to time, in this order (default: this "
                         "one)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--designs", action="store_true",
                    help="also time the FPS instances on uniform rooms "
                         "and rooms of surfaces")
    ap.add_argument("--steps", action="store_true",
                    help="also time PointNeXt-B's S3DIS train step and "
                         "eval forward on both kinds of room")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the --designs and --steps rooms")
    ap.add_argument("--parts", default="fps,knn,knn_tiled",
                    help="comma-separated subset of fps,knn,knn_tiled")
    ap.add_argument("--unchecked", nargs="*", default=[],
                    help="roots whose tiled kNN calls are timed without "
                         "holding their outputs, after --roots")
    ap.add_argument("--clouds", help=argparse.SUPPRESS)
    ap.add_argument("--rooms", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=os.path.join(
        REPO, "build", "fps_knn_timing.jsonl"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if args.child:
        print(json.dumps(child(args.child, args.clouds or "",
                               args.rooms or "", args.parts,
                               args.child not in args.unchecked)),
              flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lines = [json.dumps({"nvidia_smi": smi})]
    print(lines[0], flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    extra = []
    if args.designs:
        import numpy as np
        path = os.path.join(os.path.dirname(args.out), "fps_design_clouds.npz")
        np.savez(path, **{f"{k}/{n}": v
                          for (k, n), v in design_clouds(args.seed).items()})
        extra = ["--clouds", path]
    if args.steps:
        import numpy as np
        path = os.path.join(os.path.dirname(args.out), "fps_step_rooms.npz")
        np.savez(path, **step_rooms(args.seed))
        extra += ["--rooms", path]
    runs = [(root, []) for root in args.roots] + [
        (root, ["--unchecked", root, "--parts", "knn_tiled"])
        for root in args.unchecked]
    for root, flags in runs:
        got = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", root, "--parts", args.parts]
                             + extra + flags,
                             capture_output=True, text=True)
        if got.returncode != 0:
            sys.stderr.write(got.stdout + got.stderr)
            return got.returncode
        lines.append(got.stdout.strip().splitlines()[-1])
        print(lines[-1], flush=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
