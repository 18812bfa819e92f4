"""Mesh construction of the port — the twin of ``repro/launch/mesh.py``.

A mesh here is a ``core.pgl.VirtualMesh``: named axes over virtual ranks
that share one torch device. ``make_production_mesh`` (JAX's 16 x 16 or
2 x 16 x 16 slice for the dry-run) is not ported: it comes with the
dry-run, ROADMAP A14.
"""

from __future__ import annotations

import torch

from repro_torch.core.pgl import VirtualMesh


def make_mesh(shape, axes, device="cpu") -> VirtualMesh:
    """Arbitrary mesh of virtual ranks on ``device`` (tests, calibration)."""
    return VirtualMesh(shape, axes, device)


def device_fingerprint(mesh: VirtualMesh | None = None, *,
                       device=None) -> dict:
    """Identity of the device a calibration was (or would be) taken on.

    ``core/autotune.py`` stamps every calibration table with it, so a table
    measured on one card is never applied to another device. ``backend`` is
    ``"cuda"`` or ``"cpu"``, ``device_kind`` the card's name
    (``torch.cuda.get_device_name``) or ``"cpu"``, ``n_devices`` the mesh's
    rank count (1 without a mesh). The device is the mesh's, else
    ``device``, else the GPU when there is one."""
    if mesh is not None:
        dev = mesh.device
    elif device is not None:
        dev = torch.device(device)
    else:
        dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
    else:
        kind = dev.type
    return {"backend": dev.type, "device_kind": kind,
            "n_devices": mesh.size if mesh is not None else 1}
