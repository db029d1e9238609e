"""Neighborhood grouping (ball query / group-all) as plain callables.

Counterpart of ``adaptpoint_tpu/models/layers/group_layers.py``. Returns are
channels-last: dp (B, M, K, 3), fj (B, M, K, C). The SA stages of PointNeXt
group through the fused ``ops.ball_group`` instead; these serve the
group-all stage and the non-fused groupers.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...ops import ball_query, index_points

__all__ = ["QueryAndGroup", "GroupAll", "create_grouper",
           "get_aggregation_features"]


@dataclass(frozen=True)
class QueryAndGroup:
    """Ball-query grouping (parity: group.py QueryAndGroup).

    relative_xyz subtracts the query center; normalize_dp divides by radius.
    """

    radius: float
    nsample: int
    relative_xyz: bool = True
    normalize_dp: bool = False

    def __call__(self, query_xyz, support_xyz, features=None):
        idx = ball_query(self.radius, self.nsample, support_xyz, query_xyz)
        dp = index_points(support_xyz, idx)  # (B, M, K, 3)
        if self.relative_xyz:
            dp = dp - query_xyz[:, :, None, :]
            if self.normalize_dp:
                dp = dp / self.radius
        fj = index_points(features, idx) if features is not None else None
        return dp, fj


@dataclass(frozen=True)
class GroupAll:
    """All points in one group (parity: group.py GroupAll)."""

    def __call__(self, query_xyz, support_xyz, features=None):
        dp = support_xyz[:, None, :, :]  # (B, 1, N, 3)
        fj = features[:, None, :, :] if features is not None else None
        return dp, fj


def create_grouper(group_args: dict):
    """Grouper factory (parity: group.py create_grouper)."""
    args = dict(group_args or {})
    method = args.pop("NAME", "ballquery")
    radius = args.pop("radius", 0.1)
    nsample = args.pop("nsample", 20)
    kwargs = {k: v for k, v in args.items()
              if k in ("relative_xyz", "normalize_dp")}
    if nsample is None:
        return GroupAll()
    if method == "ballquery":
        return QueryAndGroup(float(radius), int(nsample), **kwargs)
    raise ValueError(f"grouper {method} is not ported yet")


def get_aggregation_features(p, dp, f, fj, feature_type: str = "dp_fj"):
    """Per-neighbor features (parity: group.py get_aggregation_features).

    p (B,M,3), dp (B,M,K,3), f (B,M,C) center features (or None),
    fj (B,M,K,C) neighbor features.
    """
    if feature_type == "dp_fj":
        return torch.cat([dp, fj], dim=-1)
    df = fj - f[:, :, None, :]
    if feature_type == "dp_fj_df":
        return torch.cat([dp, fj, df], dim=-1)
    if feature_type == "pi_dp_fj_df":
        pi = p[:, :, None, :].expand_as(dp)
        return torch.cat([pi, dp, fj, df], dim=-1)
    if feature_type == "dp_df":
        return torch.cat([dp, df], dim=-1)
    raise ValueError(f"unknown feature_type {feature_type}")
