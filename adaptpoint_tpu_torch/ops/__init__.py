"""Dispatching op layer: the CUDA kernels for CUDA tensors, plain PyTorch for CPU ones.

Counterpart of ``adaptpoint_tpu/ops/__init__.py``. The tensor's device is
the only thing that selects a branch: a CUDA tensor launches the kernel (or
the wrapper raises), a CPU tensor runs the plain version. There is no
environment switch, no work threshold and no fallback.
"""
from __future__ import annotations

import torch

from . import (attention, ballgroup, ballgroup_max, fpinterp, fpsample,
               gather, knn, saeval)
from .ballgroup import ball_group_plain
from .gather import gather_rows_plain
from .geometry import (ball_query, fps_prefix_idx, square_distance,
                       furthest_point_sample as furthest_point_sample_plain,
                       index_points as index_points_plain)
from .saeval import sa_eval_plain

__all__ = ["furthest_point_sample", "ball_group", "ball_group_max", "sa_eval",
           "sa_train", "gather_rows",
           "fps", "ball_query", "index_points", "fps_prefix_idx",
           "square_distance", "knn_point", "three_nn", "three_interpolation",
           "fused_self_attention", "launch_counts", "reset_launch_counts",
           "KERNEL_MODULES"]

# kernel name -> (module holding its wrapper, name of its launch counter)
KERNEL_MODULES = {"fps": (fpsample, "LAUNCHES"),
                  "ball_group": (ballgroup, "LAUNCHES"),
                  "ball_group_bwd": (ballgroup, "LAUNCHES_BWD"),
                  "ball_group_max": (ballgroup_max, "LAUNCHES"),
                  "ball_group_max_bwd": (ballgroup_max, "LAUNCHES_BWD"),
                  "sa_eval": (saeval, "LAUNCHES"),
                  "sa_train": (saeval, "LAUNCHES_TRAIN"),
                  "sa_train_bwd": (saeval, "LAUNCHES_TRAIN_BWD"),
                  "gather_rows": (gather, "LAUNCHES"),
                  "gather_rows_bwd": (gather, "LAUNCHES_BWD"),
                  "mha": (attention, "LAUNCHES"),
                  "mha_bwd": (attention, "LAUNCHES_BWD"),
                  "knn": (knn, "LAUNCHES"),
                  "fpinterp": (fpinterp, "LAUNCHES"),
                  "fpinterp_bwd": (fpinterp, "LAUNCHES_BWD")}


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz (B, N, 3) -> idx (B, npoint) int32 (semantics: ``geometry``).
    Indices carry no gradient: the input is detached first."""
    xyz = xyz.detach()
    if _on_cuda(xyz):
        return fpsample.furthest_point_sample_cuda(xyz.contiguous(), npoint)
    return furthest_point_sample_plain(xyz, npoint)


def _f32_features(feats: torch.Tensor) -> torch.Tensor:
    """bf16 features (the bf16 compute policy's) as the f32 the kernels
    take, which holds them exactly; others as they are."""
    return feats.float() if feats.dtype == torch.bfloat16 else feats


def ball_group(radius: float, nsample: int, xyz, query_idx, feats,
               relative: bool = True, normalize_dp: bool = False):
    """(new_xyz (B,M,3), fi (B,M,C), dpfj (B,K,M,3+C), idx (B,M,K)).
    Differentiable in ``xyz`` and ``feats`` on both devices: the backward
    kernel on CUDA, PyTorch's autograd of the plain version on the CPU.
    bf16 features give ``fi`` and ``dpfj`` in bf16, as the JAX package's
    ``ball_group`` does under its bf16 policy."""
    in_dt = feats.dtype
    feats = _f32_features(feats)
    if _on_cuda(xyz):
        out = ballgroup.BallGroup.apply(
            xyz.contiguous(), query_idx.int().contiguous(),
            feats.contiguous(), float(radius), int(nsample), bool(relative),
            bool(normalize_dp))
    else:
        out = ball_group_plain(radius, nsample, xyz, query_idx, feats,
                               relative, normalize_dp)
    if in_dt != torch.bfloat16:
        return out
    new_xyz, fi, dpfj, idx = out
    return new_xyz, fi.to(in_dt), dpfj.to(in_dt), idx


def ball_group_max(radius: float, nsample: int, xyz, query_idx, feats):
    """Max-pooled ball group: ``(new_xyz (B,M,3), fi, fmax, fmin (B,M,C))``,
    values rounded to bf16 as the TPU kernel rounds them, the (B, K, M, C)
    grouped tensor never formed. Differentiable in ``xyz`` and ``feats``,
    each max / min cotangent to its first winning slot: the kernels on CUDA,
    the plain versions on the CPU (``ops.ballgroup_max``). bf16 features
    give ``fi``, ``fmax`` and ``fmin`` in bf16 (the same values) and their
    cotangent in bf16, as under the JAX package's bf16 policy."""
    in_dt = feats.dtype
    feats = _f32_features(feats)
    if _on_cuda(xyz):
        out = ballgroup_max.BallGroupMax.apply(
            xyz.contiguous(), query_idx.int().contiguous(),
            feats.contiguous(), float(radius), int(nsample), True)
    else:
        out = ballgroup_max.BallGroupMax.apply(xyz, query_idx, feats,
                                               float(radius), int(nsample),
                                               False)
    if in_dt != torch.bfloat16:
        return out
    return (out[0],) + tuple(t.to(in_dt) for t in out[1:])


def sa_eval(radius: float, nsample: int, xyz, query_idx, feats, w1, b1, w2,
            b2, relative: bool = True, normalize_dp: bool = False,
            packed=None):
    """Fused eval SA stage: (new_xyz, fi = bf16(f), out (B,M,cout)), all f32
    (bf16 features too, as the TPU kernel returns them). ``packed``
    (``saeval.pack_weights`` of the same weights) spares the kernel's weight
    packing on CUDA."""
    feats = _f32_features(feats)
    if _on_cuda(xyz):
        return saeval.sa_eval_cuda(
            radius, nsample, xyz.contiguous(), query_idx.int().contiguous(),
            feats.contiguous(), w1, b1, w2, b2, relative, normalize_dp,
            packed)
    return sa_eval_plain(radius, nsample, xyz, query_idx, feats, w1, b1, w2,
                         b2, relative, normalize_dp)


def sa_train(radius: float, nsample: int, xyz, query_idx, feats, w1, b1, w2,
             b2, relative: bool = True, normalize_dp: bool = False,
             packed=None):
    """The fused SA stage under autograd: :func:`sa_eval`'s outputs,
    differentiable in ``xyz``, ``feats`` and the folded weights, each output's
    cotangent to its first winning slot (``ops.saeval.SaTrain``). The weight
    gradients are computed only where a folded weight requires one. bf16
    features get their cotangent in bf16."""
    feats = _f32_features(feats)
    if _on_cuda(xyz):
        return saeval.SaTrain.apply(
            xyz.contiguous(), query_idx.int().contiguous(), feats.contiguous(),
            w1, b1, w2, b2, float(radius), int(nsample), bool(relative),
            bool(normalize_dp), packed, True)
    return saeval.SaTrain.apply(xyz, query_idx, feats, w1, b1, w2, b2,
                                float(radius), int(nsample), bool(relative),
                                bool(normalize_dp), None, False)


def gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Exact row gather: points (B, N, C) f32 or bf16, idx (B, M) int ->
    (B, M, C); its gradient is the scatter-add onto the gathered rows."""
    if _on_cuda(points):
        return gather.GatherRows.apply(points.contiguous(),
                                       idx.int().contiguous())
    return gather_rows_plain(points, idx)


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, ...) int -> (B, ..., C), differentiable in
    ``points``. On CUDA every (B, N, C) float32 or bfloat16 gather, whatever
    the rank of ``idx`` (>= 2), is the row-gather kernel on the flattened
    index, and its gradient the scatter-add kernel; other types and ranks
    take the plain gather."""
    if (_on_cuda(points) and points.dim() == 3 and idx.dim() >= 2
            and points.dtype in (torch.float32, torch.bfloat16)
            and idx.numel() > 0):
        flat = idx.reshape(points.shape[0], -1)
        out = gather_rows(points, flat)
        return out.reshape(tuple(idx.shape) + (points.shape[-1],))
    return index_points_plain(points, idx)


def knn_point(nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """The ``nsample`` nearest of xyz (B, N, C) to each of new_xyz (B, M, C):
    ``(d2, idx)``, both (B, M, nsample), nearest first, ties to the lowest
    index; a cloud smaller than ``nsample`` repeats its nearest.

    The indices come from the kNN kernel (CUDA) or its plain version (CPU)
    and carry no gradient. ``d2`` is recomputed from the gathered rows in
    the expanded form of ``square_distance``, so it is differentiable in
    both clouds on either device."""
    support = xyz.detach().float().contiguous()
    query = new_xyz.detach().float().contiguous()
    if _on_cuda(xyz):
        idx = knn.knn_idx_cuda(int(nsample), support, query)
    else:
        idx = knn.knn_idx_plain(int(nsample), support, query)
    nbr = index_points(xyz, idx).float()  # (B, M, K, C)
    q = new_xyz.float()
    cross = torch.einsum("bmc,bmkc->bmk", q, nbr)
    d2 = (q ** 2).sum(dim=-1)[..., None] + (nbr ** 2).sum(dim=-1) - 2.0 * cross
    return d2, idx


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """3 nearest known (B, M, 3) points of each unknown (B, N, 3) point:
    euclidean distances (B, N, 3) and int32 indices (B, N, 3)."""
    d2, idx = knn_point(3, known, unknown)
    return torch.sqrt(torch.clamp(d2, min=0.0)), idx


def three_interpolation(unknown_xyz: torch.Tensor, known_xyz: torch.Tensor,
                        known_feat: torch.Tensor) -> torch.Tensor:
    """Feature-propagation upsampling: 3-NN, weights from reciprocal
    distances (eps 1e-8) normalised to sum 1, then the weighted sum of the
    three neighbours' features, f32 weights throughout.

    bf16 features (the bf16 policy's) take the weighted gather of
    ``ops.fpinterp`` (the kernel on CUDA, its plain version on the CPU) and
    give f32, as the JAX package's TPU kernel does. Other features take the
    gather and the weighted sum as separate ops (the JAX package's
    composite) and keep their type."""
    dist, idx = three_nn(unknown_xyz, known_xyz)
    recip = 1.0 / (dist + 1e-8)
    weight = recip / recip.sum(dim=2, keepdim=True)
    if known_feat.dtype == torch.bfloat16:
        return fpinterp.WeightedGather3.apply(
            known_feat.contiguous(), idx.int().contiguous(),
            weight.float().contiguous(), _on_cuda(known_feat))
    gathered = index_points(known_feat, idx)  # (B, N, 3, C)
    return (gathered * weight[..., None]).sum(dim=2)


def fused_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """softmax(q k^T / scale) v over flattened heads (BH, N, d), bf16
    operands for both products, f32 softmax and output; differentiable, with
    the flash backward on both devices (``ops.attention``)."""
    if _on_cuda(q):
        return attention.FusedSelfAttention.apply(
            q.contiguous(), k.contiguous(), v.contiguous(), float(scale))
    return attention.PlainSelfAttention.apply(q, k, v, float(scale))


def fps(data: torch.Tensor, number: int) -> torch.Tensor:
    """FPS on ``data[..., :3]`` then the row gather: (B, N, C) -> (B, number, C)."""
    idx = furthest_point_sample(data[..., :3], number)
    return gather_rows(data, idx)


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNEL_MODULES.values():
        setattr(mod, attr, 0)
