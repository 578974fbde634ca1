"""QuantPlan: the serializable per-site quantization state.

JAX analogue of the reference's node-metadata bus (SURVEY.md §1): where
the reference stamps ``node.meta["qconfig"]`` / ``meta["input_scale"]`` /
``meta["input"]`` on ONNX IR nodes (``pre_passes/__init__.py:17-26``,
``calibrate.py:254-307``), we keep a :class:`QuantPlan` keyed by *site name* —
one :class:`PlanEntry` per quantizable linear site in the model's param tree.

The plan is produced by :func:`build_plan`, filled by calibration and the
pre-passes, consumed by the weight transform, and saved next to the quantized
checkpoint so the engine can reconstruct execution metadata.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import numpy as np

from onnx_quantize_tpu._logging import get_logger
from onnx_quantize_tpu.core.qconfig import QConfig

logger = get_logger(__name__)

__all__ = ["LinearSite", "PlanEntry", "QuantPlan", "build_plan", "resolve_group_size"]


@dataclasses.dataclass(frozen=True)
class LinearSite:
    """A quantizable matmul site discovered in a model.

    ``op_type`` follows the reference vocabulary: a Linear with bias is a
    "Gemm" site, without bias a "MatMul" site.
    """

    name: str
    op_type: str  # "MatMul" | "Gemm"
    param_path: tuple[str, ...]  # path of the site's param dict in the pytree
    in_features: int
    out_features: int


@dataclasses.dataclass
class PlanEntry:
    """Per-site quantization state (the analogue of ``ir.Node.meta``)."""

    site: LinearSite
    qconfig_dict: dict[str, Any] | None = None  # ≙ meta["qconfig"]
    group_size: int | None = None  # resolved against in_features

    # Calibrated static activation qparams (≙ meta["input_scale"] etc.).
    input_scale: np.ndarray | None = None
    input_zero_point: np.ndarray | None = None
    output_scale: np.ndarray | None = None
    output_zero_point: np.ndarray | None = None

    # Raw concatenated input activations for GPTQ/AWQ/SmoothQuant (≙ meta["input"]).
    captured_input: np.ndarray | None = None

    @property
    def name(self) -> str:
        return self.site.name

    def qconfig(self) -> QConfig:
        """Reconstruct the QConfig from the stamped dict (registry-dispatched)."""
        assert self.qconfig_dict is not None, f"No qconfig stamped on site {self.name}"
        return QConfig(**self.qconfig_dict)


@dataclasses.dataclass
class QuantPlan:
    entries: dict[str, PlanEntry] = dataclasses.field(default_factory=dict)

    def __contains__(self, name: str) -> bool:
        return name in self.entries

    def __getitem__(self, name: str) -> PlanEntry:
        return self.entries[name]

    def __iter__(self):
        return iter(self.entries.values())

    def __len__(self) -> int:
        return len(self.entries)

    def get(self, name: str) -> PlanEntry | None:
        return self.entries.get(name)


def resolve_group_size(in_channels: int, group_size: int | None) -> int | None:
    """Clamp the group size against the site's in_channels.

    Mirrors ``qrules/_common.py:13-29``: a group size larger than in_channels or
    one that does not divide it falls back to ``in_channels`` (i.e. one group).
    """
    if not group_size:
        return group_size

    if group_size > in_channels:
        logger.debug(
            "Adjusting group size from %d to %d as it exceeds the number of "
            "input channels.", group_size, in_channels,
        )
        return in_channels
    if in_channels % group_size != 0:
        logger.debug(
            "Adjusting group size from %d to %d as it does not divide the "
            "number of input channels.", group_size, in_channels,
        )
        return in_channels
    return group_size


def get_target_sites(
    sites: list[LinearSite],
    target_op_types,
    ignore_patterns=(),
) -> list[LinearSite]:
    """Filter sites by op type and ignore regexes (ref ``calibrate.py:48-89``)."""
    compiled = [re.compile(p) for p in ignore_patterns]

    def is_ignored(name: str) -> bool:
        return bool(name) and any(p.search(name) for p in compiled)

    return [
        s
        for s in sites
        if s.op_type in target_op_types and not is_ignored(s.name)
    ]


def build_plan(sites: list[LinearSite], qconfig: QConfig) -> QuantPlan:
    """Create a plan with one entry per target site (no qconfig stamped yet).

    Stamping happens separately via :func:`stamp_qconfig` to preserve the
    reference's ordering (calibrate -> stamp -> pre-passes).
    """
    targets = get_target_sites(sites, qconfig.target_op_types, qconfig.ignore)
    plan = QuantPlan()
    for site in targets:
        gs = qconfig.weights.group_size if qconfig.weights is not None else None
        plan.entries[site.name] = PlanEntry(
            site=site,
            group_size=resolve_group_size(site.in_features, gs),
        )
    return plan


def stamp_qconfig(plan: QuantPlan, qconfig: QConfig) -> None:
    """Stamp the serialized qconfig on every entry (≙ ``_add_qconfig_to_nodes``).

    ``calibration_data`` is excluded from the stamp, as in the reference
    (``pre_passes/__init__.py:17-26``).
    """
    dumped = qconfig.model_dump(exclude={"calibration_data"})
    for entry in plan:
        entry.qconfig_dict = dict(dumped)
