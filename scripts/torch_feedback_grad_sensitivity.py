#!/usr/bin/env python3
"""How far can an f32 ``gan_step`` of the PyTorch port be held to a float64 one?

    python3 scripts/torch_feedback_grad_sensitivity.py [--batch 8] [--points 2048]

Runs on the CPU through the plain versions of the kernels, at the full width
of ``cfgs/scanobjectnn/pointnext-s_adaptpoint_1.yaml`` unless ``--cfg`` names
another file, with seeded weights, clouds and draws (the gumbel noise moved off
near-ties of the hard keep/drop choice, as ``chip_smoke.py`` does). Prints one
JSON object:

- ``classifier``: the frozen classifier's loss gradient with respect to its
  input cloud (the fake clouds of a generator call). ``f32_vs_f64``: f32
  against float64 on identical clouds. ``perturbed_1e-06`` / ``_1e-05``:
  float64 against float64 after gaussian noise of that size on the kept
  points, with the same FPS picks: the relative 2-norm of the gradient's
  change, the largest change of a logit and how many ball-query slots changed.
  The classifier is no continuous function of its input (ball memberships and
  max-pool winners flip), so its gradient jumps under perturbations far below
  what f32 arithmetic leaves in the fake clouds.
- ``gan_step``: the generator's gradient of one whole step, f32 against
  float64, as the relative 2-norm over all its tensors and for the worst
  tensor (scale floored at a thousandth of the whole), the float64 step
  taking the f32 step's FPS picks and its groupers' rounding decisions
  (their bf16 values and winning slots; ``choices_the_copy_would_make``
  counts those it would have made otherwise): ``own_clouds``, each step on
  the fake clouds it made; ``shared_clouds``, the float64 step
  differentiated at the f32 step's fake clouds (a straight-through
  substitution), which is how ``chip_smoke.py`` holds the card's step to
  its float64 copy; ``no_feedback``, own clouds with ``feedbackloss_ratio``
  0, where the classifier is out of the loss.
- ``gan_step_fused``: the same on the route the card takes, both classifier
  passes through the fused SA stages: ``shared_clouds`` as above;
  ``shared_choices``, the float64 step also taking the f32 step's rounded
  grouper values and max-pool winners (``chip_smoke.winner_choices``), how
  ``chip_smoke.py`` holds the step now; ``shared_choices_no_feedback``
  likewise without the feedback term; ``choices_the_copy_would_make``: how
  many of those the float64 step would have made otherwise.
- ``classifier_fused``: the classifier's input gradient on its fused route
  under autograd, f32 against float64, on its own winners and on the f32
  ones.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (seeded batches, BN calibration, FPS replay)
from adaptpoint_tpu_torch import ops  # noqa: E402
from adaptpoint_tpu_torch.adapt import draw_wolf  # noqa: E402
from adaptpoint_tpu_torch.engine import (GanDraws, build_gan,  # noqa: E402
                                         make_gan_step)
from adaptpoint_tpu_torch.loss import build_criterion_from_cfg  # noqa: E402
from adaptpoint_tpu_torch.models import build_model_from_cfg  # noqa: E402
from adaptpoint_tpu_torch.utils import EasyConfig  # noqa: E402

MARGIN = chip_smoke.MASK_MARGIN


def rel_l2(a, b):
    """Whole and worst-tensor relative 2-norm of dicts of gradients."""
    total = float(torch.cat([v.flatten() for v in b.values()]).norm())
    diff = float(torch.cat([(a[n] - b[n]).flatten() for n in b]).norm())
    worst = max((float((a[n] - b[n]).norm()
                       / max(float(b[n].norm()), 1e-3 * total)), n) for n in b)
    return {"whole": diff / total, "worst_tensor": list(worst)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", default=os.path.join(
        ROOT, "cfgs/scanobjectnn/pointnext-s_adaptpoint_1.yaml"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--points", type=int, default=2048)
    ap.add_argument("--calib-points", type=int, default=1024)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    B, N = args.batch, args.points
    cfg = EasyConfig()
    cfg.load(args.cfg, recursive=True)
    classes = int(cfg.model.cls_args.num_classes)
    chip_smoke.CLASSES = classes
    batch = chip_smoke.blob_batches(np.random.default_rng(4), 1, B, N)[0]
    x, y = torch.from_numpy(batch["x"]), torch.from_numpy(batch["y"])
    pc = x[..., :3].contiguous()
    cls0 = build_model_from_cfg(cfg.model, seed=1, device="cpu")
    chip_smoke.calibrate_bn(cls0, x[:, :args.calib_points])
    gen0, dis0, _, _, _ = build_gan(cfg, seed=5, device="cpu")

    # draws, with the gumbel noise moved off near-ties of the hard choice
    host = torch.Generator().manual_seed(6)
    wolf = draw_wolf(host, B, gen0.w_num_anchor, "cpu")
    u = torch.rand((B, N, 2), generator=host).clamp_(min=1e-20)
    gumbel = -torch.log(-torch.log(u))
    scout, seen = copy.deepcopy(gen0).train(), {}
    hook = scout.predict_prob_layer.fuse_masking.register_forward_hook(
        lambda _m, _i, out: seen.__setitem__("logits", out.detach()))
    with torch.no_grad():
        scout(pc, wolf, gumbel,
              first_fps_idx=ops.furthest_point_sample(pc, N // 2))
    hook.remove()
    gap = seen["logits"].float() + gumbel
    gap = gap[..., 0] - gap[..., 1]
    near = gap.abs() < MARGIN
    gumbel[..., 0] += MARGIN * near * torch.where(gap >= 0, 1.0, -1.0)

    def models(dtype, ratio=None, fused=False):
        c = copy.deepcopy(cfg)
        if ratio is not None:
            c.feedbackloss_ratio = ratio
        g, d, g_opt, d_opt, st = build_gan(c, device="cpu")
        cls = build_model_from_cfg(c.model, device="cpu")
        for dst, src in ((g, gen0), (d, dis0), (cls, cls0)):
            dst.to(dtype)
            dst.load_state_dict(src.state_dict())
        routes = chip_smoke.fused_routes() if fused \
            else contextlib.nullcontext()
        with routes:
            step = make_gan_step(g, d, g_opt, d_opt, cls.eval(), c)
        return st, step, cls

    def run(dtype, log, replay=None, clouds=None, ratio=None, fused=False,
            winners=None, winner_replay=None):
        """One step (the discriminator's dropout masks from one seed);
        returns the generator's gradients and the step's own fake clouds.
        ``winners`` logs (or with ``winner_replay`` replays) the grouper's
        and the fused SA's choices."""
        st, step, _ = models(dtype, ratio, fused)
        own = {}

        def keep(_m, _i, out):
            own["gen"] = out[1].detach().double()
            if clouds is None:
                return None
            return out[0], out[1] + (clouds.to(out[1]) - out[1]).detach()
        st.generator.register_forward_hook(keep)
        masks = torch.Generator().manual_seed(7)
        draws = GanDraws(
            wolf, gumbel,
            [torch.rand((B, w), generator=masks) >= 0.4 for w in (512, 256)],
            [torch.rand((2 * B, w), generator=masks) >= 0.4
             for w in (512, 256)])
        with chip_smoke.fps_choices(log, replay), chip_smoke.winner_choices(
                {} if winners is None else winners, winner_replay):
            step(st, {"x": x.to(dtype), "y": y}, draws, 3.0)
        return ({n: p.grad.double()
                 for n, p in st.generator.named_parameters()}, own["gen"])

    out = {"batch": B, "points": N, "moved_points": int(near.sum())}
    log, log0, wl, wl0, own = [], [], {}, {}, {}
    g32, clouds32 = run(torch.float32, log, winners=wl)
    g64, clouds64 = run(torch.float64, log, replay={}, winners=wl,
                        winner_replay=own)
    g64_shared, _ = run(torch.float64, log, replay={}, clouds=clouds32,
                        winners=wl, winner_replay={})
    g32_nofb, _ = run(torch.float32, log0, ratio=0.0, winners=wl0)
    g64_nofb, _ = run(torch.float64, log0, replay={}, ratio=0.0, winners=wl0,
                      winner_replay={})
    out["gan_step"] = {
        "clouds_max_abs_diff": float((clouds32 - clouds64).abs().max()),
        "mask_flips": int(((clouds32.abs().sum(-1) != 0)
                           != (clouds64.abs().sum(-1) != 0)).sum()),
        "own_clouds": rel_l2(g32, g64),
        "shared_clouds": rel_l2(g32, g64_shared),
        "no_feedback": rel_l2(g32_nofb, g64_nofb),
        "choices_the_copy_would_make": own}
    fl, wl, wl0, rep, rep0 = [], {}, {}, {}, {}
    g32, clouds32 = run(torch.float32, fl, fused=True, winners=wl)
    g64, _ = run(torch.float64, fl, replay={}, clouds=clouds32, fused=True)
    g64_shared, _ = run(torch.float64, fl, replay={}, clouds=clouds32,
                        fused=True, winners=wl, winner_replay=rep)
    g32_nofb, _ = run(torch.float32, fl, replay={}, ratio=0.0, fused=True,
                      winners=wl0)
    g64_nofb, _ = run(torch.float64, fl, replay={}, clouds=clouds32,
                      ratio=0.0, fused=True, winners=wl0, winner_replay=rep0)
    out["gan_step_fused"] = {
        "shared_clouds": rel_l2(g32, g64),
        "shared_choices": rel_l2(g32, g64_shared),
        "shared_choices_no_feedback": rel_l2(g32_nofb, g64_nofb),
        "choices_the_copy_would_make": rep}

    # the classifier alone, on the float64 step's fake clouds
    criterion = build_criterion_from_cfg(cfg.criterion_args)
    extra = x[..., 3:int(cfg.model.encoder_args.in_channels)]
    fps_log = []

    def input_grad(dtype, cloud, replay=None):
        _, _, cls = models(dtype)
        for p in cls.parameters():
            p.requires_grad_(False)
        cloud = cloud.to(dtype).clone().requires_grad_()
        slots, own_bg = [], ops.ball_group

        def ball_group(*a, **k):
            res = own_bg(*a, **k)
            slots.append(res[3])
            return res
        ops.ball_group = ball_group
        try:
            with chip_smoke.fps_choices(fps_log, replay):
                logits = cls(cloud, torch.cat([cloud, extra.to(dtype)], -1),
                             fused_eval=False).float()
        finally:
            ops.ball_group = own_bg
        (grad,) = torch.autograd.grad(criterion(logits, y), cloud)
        return grad.double(), logits.detach().double(), slots

    ref, ref_logits, ref_slots = input_grad(torch.float64, clouds64)
    got, _, _ = input_grad(torch.float32, clouds64.float(), replay={})
    out["classifier"] = {"f32_vs_f64": float((got - ref).norm() / ref.norm())}

    def fused_input_grad(dtype, winners, winner_replay=None):
        _, _, cls = models(dtype)
        for p in cls.parameters():
            p.requires_grad_(False)
        cloud = clouds64.to(dtype).clone().requires_grad_()
        with chip_smoke.fps_choices(fps_log, {}), \
                chip_smoke.winner_choices(winners, winner_replay):
            logits = cls(cloud, torch.cat([cloud, extra.to(dtype)], -1),
                         fused_eval=True)
        (grad,) = torch.autograd.grad(criterion(logits.float(), y), cloud)
        return grad.double()

    wl = {}
    got = fused_input_grad(torch.float32, wl)
    rel = [float((got - fused_input_grad(torch.float64, w, r)).norm()
                 / got.norm()) for w, r in (({}, None), (wl, {}))]
    out["classifier_fused"] = {"f32_vs_f64": rel[0],
                               "f32_vs_f64_shared_winners": rel[1]}
    kept = (clouds64.abs().sum(-1, keepdim=True) != 0)
    for size in (1e-6, 1e-5):
        noise = torch.randn(clouds64.shape, dtype=torch.float64,
                            generator=torch.Generator().manual_seed(1))
        got, logits, slots = input_grad(torch.float64,
                                        clouds64 + size * noise * kept,
                                        replay={})
        out["classifier"][f"perturbed_{size:g}"] = {
            "grad_rel_l2": float((got - ref).norm() / ref.norm()),
            "logits_max_abs_diff": float((logits - ref_logits).abs().max()),
            "ball_slots_changed": int(sum((a != b).sum() for a, b in
                                          zip(slots, ref_slots))),
            "ball_slots": int(sum(a.numel() for a in ref_slots))}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
