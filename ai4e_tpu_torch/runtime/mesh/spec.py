"""Declarative serving-mesh spec — the shape a worker's endpoint serves.
A copy of ``ai4e_tpu/runtime/mesh/spec.py``; only the device count became
the rank count.

``MeshLayout`` is the operator-facing grammar (``AI4E_RUNTIME_MESH_SPEC``):
a dp×tp×sp shape string like ``"dp=8"`` or ``"dp=2,tp=2"``, validated
before any device work happens and exposed on ``GET /v1/models`` so clients
and the orchestrator can reason about the shape a worker serves. It carries
no torch objects; the translation to ``parallel.sharding.MeshSpec`` and a
``DeviceMesh`` lives in ``placement.mesh_for_layout``. In the port one
rank of ``torch.distributed`` is one device of the mesh.

The **tier label** is the orchestration hook: distinct mesh shapes are
distinct cost tiers in the placement walk (``orchestration/core.py``
keys costs by backend-URI substring), so a route that carries
``tier_label`` — e.g. ``/v1/detector-mesh-dp8`` — lets
``orchestration_costs="mesh-dp8=1,mesh-tp4=4"`` price a dp=8 small-model
endpoint against a tp=4 large-model endpoint in the cheapest-first walk.
"""

from __future__ import annotations

from dataclasses import dataclass

#: Serving meshes are declared over these axes, in this order. ``fsdp``
#: and ``ep`` stay runtime-internal (the low-level AI4E_RUNTIME_FSDP/EP
#: knobs) — a serving spec describes request placement, and requests ride
#: the batch (dp), feature (tp) and sequence (sp) dimensions.
AXES = ("dp", "tp", "sp")


class MeshSpecError(ValueError):
    """A mesh spec string or its device assignment is invalid — raised at
    registration/boot, never on the request path."""


@dataclass(frozen=True)
class MeshLayout:
    """A validated serving-mesh shape. ``dp`` shards the batch dimension,
    ``tp`` the feature dimensions (via partition rules), ``sp`` the
    sequence dimension (ring/Ulysses attention)."""

    dp: int = 1
    tp: int = 1
    sp: int = 1

    def __post_init__(self):
        for axis in AXES:
            v = getattr(self, axis)
            if not isinstance(v, int) or v < 1:
                raise MeshSpecError(
                    f"mesh axis {axis}={v!r} must be a positive int")

    @property
    def size(self) -> int:
        """Devices this layout occupies."""
        return self.dp * self.tp * self.sp

    @property
    def data_axis_multiple(self) -> int:
        """Every batch bucket must divide evenly over the batch axis —
        the SPMD rule ``ModelRuntime.register`` pads buckets to."""
        return self.dp

    @property
    def tier_label(self) -> str:
        """Stable substring identifying this shape as an orchestration
        cost tier (``"mesh-dp8"``, ``"mesh-tp4"``, ``"mesh-dp2tp2"``).
        Unit axes are elided; the trivial 1×1×1 layout is ``"mesh-dp1"``."""
        parts = [f"{axis}{getattr(self, axis)}"
                 for axis in AXES if getattr(self, axis) > 1]
        return "mesh-" + ("".join(parts) or "dp1")

    @classmethod
    def parse(cls, text: str) -> "MeshLayout":
        """Parse the spec grammar: comma-separated ``axis=N`` with axes
        from ``dp``/``tp``/``sp``, each at most once, N a positive int.
        Raises ``MeshSpecError`` with the offending token named."""
        seen: dict[str, int] = {}
        for token in text.split(","):
            token = token.strip()
            if not token:
                continue
            key, sep, value = token.partition("=")
            key = key.strip()
            if not sep or key not in AXES:
                raise MeshSpecError(
                    f"bad mesh spec token {token!r}: expected axis=N with "
                    f"axis in {'/'.join(AXES)}")
            if key in seen:
                raise MeshSpecError(f"mesh axis {key} given twice in {text!r}")
            try:
                n = int(value.strip())
            except ValueError:
                raise MeshSpecError(
                    f"mesh axis {key}={value.strip()!r} is not an int") from None
            seen[key] = n
        if not seen:
            raise MeshSpecError(f"empty mesh spec {text!r}")
        return cls(**seen)

    def validate(self, device_count: int, process_count: int = 1) -> None:
        """Device-assignment check, run at registration: the layout must
        cover exactly the ranks present (one device a rank), and on a
        multi-process mesh each process must hold an equal slice of them.
        A layout is never shrunk to fit."""
        if self.size != device_count:
            raise MeshSpecError(
                f"mesh spec {self.describe()['spec']} needs {self.size} "
                f"ranks, got {device_count} (start {self.size} processes "
                f"with WORLD_SIZE={self.size} and RANK=0..{self.size - 1})")
        if process_count > 1 and device_count % process_count:
            raise MeshSpecError(
                f"{device_count} devices do not split evenly over "
                f"{process_count} processes")

    def describe(self) -> dict:
        """The ``GET /v1/models`` introspection entry."""
        spec = ",".join(f"{axis}={getattr(self, axis)}" for axis in AXES
                        if getattr(self, axis) > 1) or "dp=1"
        return {"spec": spec, "dp": self.dp, "tp": self.tp, "sp": self.sp,
                "devices": self.size, "tier": self.tier_label,
                "data_axis_multiple": self.data_axis_multiple}


def parse_mesh_spec(text: str | None) -> MeshLayout | None:
    """Config-surface entry point: ``None``/empty/``"off"`` means the mesh
    serving plane is off (the byte-identical default path)."""
    if text is None:
        return None
    text = text.strip()
    if not text or text.lower() == "off":
        return None
    return MeshLayout.parse(text)
