"""Production meshes and the card's peak rates (counterpart of
``repro/launch/mesh.py``).

The mesh here is *abstract*: its axis names, each axis's size and the
number of chips, which is all the sharding policy (``launch/sharding.py``)
and the dry run (``launch/dryrun.py``) read.  Single pod: 16x16 = 256
chips ("data", "model").  Multi-pod: 2x16x16 = 512 chips ("pod", "data",
"model").  A ``torch.distributed`` ``DeviceMesh`` over real cards waits
for a machine with more than one card (ROADMAP queue A, step 5).

Under PNN (the paper's scheme) the "pod" axis carries *stages*, not
replicas: each pod trains one model partition with zero inter-pod
collectives during training; under the conventional baseline the pod axis
is an outer data-parallel axis.

Two names of the reference have no counterpart: ``force_host_device_count``
(XLA's flag for host devices; the port places stages on the CPU device
itself, ``stage_devices(n, "cpu")``) and ``ICI_BW`` (the TPU's
inter-chip link; the dry run reads no collective, since the port has no
compiled program to count them in).  ``stage_devices`` is
``repro_torch.dist``'s.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.dist.placement import stage_devices  # noqa: F401


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a mesh of chips, without devices."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False,
                         shape: Optional[Tuple[int, int]] = None
                         ) -> AbstractMesh:
    """shape: optional (data, model) override, e.g. (32, 8) for an
    expert-parallel variant (model axis dividing the expert count)."""
    if shape is None:
        shape = (16, 16)
    assert shape[0] * shape[1] == 256, "one pod = 256 chips"
    full = ((2,) + tuple(shape)) if multi_pod else tuple(shape)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(axes, full)


def mesh_refusal(what: str) -> str:
    """The message of a refused option that needs a mesh of real cards."""
    return (f"{what} needs a mesh of cards, which waits for a machine with "
            "more than one card (ROADMAP queue A, step 5)")


def dp_axes(mesh) -> tuple:
    """Data-parallel axis names for this mesh (batch sharding)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def fsdp_axis(mesh) -> str:
    return "data"


def tp_axis(mesh) -> str:
    return "model"


# NVIDIA H100 SXM 80 GB at its 700 W limit (data sheet, dense), per card,
# for the roofline model.  fp32 is the CUDA cores' rate: the fp32 policy
# turns TF32 off (precision.PrecisionPolicy.apply_backend_flags).
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, tensor cores (fp16 the same)
PEAK_FLOPS_FP32 = 67e12       # FLOP/s, no TF32
HBM_BW = 3.35e12              # B/s, HBM3
