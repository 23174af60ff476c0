"""Production meshes of NVIDIA H100 SXM nodes, and their roofline peaks.

Defined as functions (never module-level meshes) so importing this module
touches no process group.  A mesh needs ``torch.distributed`` initialised
with a world of its size first: the dry run initialises a fake process
group of that size (``repro_torch.launch.dryrun``), a real job one rank a
card.  The model axis stays inside one 8-GPU NVLink node; the data (and
pod) axes cross nodes over InfiniBand.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

#: GPUs a node, joined all to all by NVLink
NODE_GPUS = 8


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """(data 32, model 8) over 256 GPUs, or (pod 2, data 32, model 8) over
    512."""
    shape = (2, 32, NODE_GPUS) if multi_pod else (32, NODE_GPUS)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_mesh_for(n_devices: int, *, model_axis: int = None,
                  device_type: str = "cuda") -> DeviceMesh:
    """Elastic helper: best (data, model) mesh for an arbitrary device
    count, the model axis within a node."""
    if model_axis is None:
        model_axis = 1
        for cand in (8, 4, 2):
            if n_devices % cand == 0:
                model_axis = cand
                break
    if n_devices % model_axis:
        raise ValueError(f"{n_devices} devices do not split into a model "
                         f"axis of {model_axis}")
    return init_device_mesh(device_type, (n_devices // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


# NVIDIA H100 SXM (data sheet; dense rates, per GPU)
PEAK_FLOPS_BF16 = 989e12  # FLOP/s
HBM_BW = 3.35e12  # B/s
NVLINK_BW = 450e9  # B/s per direction (900 GB/s both ways)
IB_BW = 50e9  # B/s: one 400 Gb/s NIC per GPU


def link_bw(axis: str) -> float:
    """The link bandwidth of a mesh axis: NVLink for the model axis inside
    a node, InfiniBand for the axes that leave it."""
    return NVLINK_BW if axis == "model" else IB_BW
