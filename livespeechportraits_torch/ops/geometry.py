"""3D head geometry: Euler rotations and batched landmark projection.

Counterpart of ``livespeechportraits_tpu/ops/geometry.py`` (``Camera``,
``euler_to_rotation``, ``euler_to_rotation_grad``, ``project_landmarks``,
``project_shoulders``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


@dataclass(frozen=True)
class Camera:
    """Pinhole camera intrinsics (the reference's funcs/utils.py:15-56)."""

    fx: float = 0.0
    fy: float = 0.0
    cx: float = 0.0
    cy: float = 0.0

    @property
    def intrinsic(self) -> np.ndarray:
        return np.array([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
                        dtype=np.float32)

    def scaled(self, transform: np.ndarray) -> "Camera":
        """The intrinsics under a 3x3 image-space transform (utils.py:48-56)."""
        s = float(transform[0, 0])
        return Camera(fx=self.fx * s, fy=self.fy * s, cx=s * self.cx + float(transform[0, 2]),
                      cy=s * self.cy + float(transform[1, 2]))


def euler_to_rotation(angles_deg: Tensor) -> Tensor:
    """Euler angles in degrees (x=pitch, y=yaw, z=roll) -> R = Rz @ Ry @ Rx,
    [..., 3] -> [..., 3, 3]."""
    rad = torch.deg2rad(angles_deg)
    x, y, z = rad[..., 0], rad[..., 1], rad[..., 2]
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    rows = [
        torch.stack([cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx], dim=-1),
        torch.stack([sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx], dim=-1),
        torch.stack([-sy, cy * sx, cy * cx], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def euler_to_rotation_grad(angles_deg: Tensor) -> Tuple[Tensor, List[Tensor]]:
    """(R, [dR/dx, dR/dy, dR/dz]) of euler_to_rotation (the reference's
    utils.py:210-227 with gradient='true'), each [..., 3, 3] in degrees'
    units: the forward-mode Jacobian of one frame, vmapped over [T, 3]."""
    R = euler_to_rotation(angles_deg)
    jac = torch.func.jacfwd(euler_to_rotation)
    if angles_deg.dim() > 1:
        jac = torch.func.vmap(jac)
    J = jac(angles_deg)  # [..., 3, 3, 3]
    return R, [J[..., 0], J[..., 1], J[..., 2]]


def project_landmarks(camera_intrinsic: Tensor, viewpoint_R: Tensor, viewpoint_T: Tensor,
                      scale: float, headposes: Tensor, pts_3d: Tensor) -> Tensor:
    """headposes [T, 6] (degrees, translation), pts_3d [T, N, 3] or [N, 3]
    -> [T, N, 2] pixels: p = scale * R(pose) @ pts + t, then the viewpoint
    transform, the intrinsics and the perspective divide."""
    headposes = torch.atleast_2d(headposes)
    if pts_3d.dim() == 2:
        pts_3d = pts_3d[None].expand(headposes.shape[0], *pts_3d.shape)
    rot = euler_to_rotation(headposes[:, :3])
    trans = headposes[:, 3:]
    p = scale * torch.einsum("tij,tnj->tni", rot, pts_3d) + trans[:, None, :]
    p = torch.einsum("ij,tnj->tni", viewpoint_R, p) + viewpoint_T[None, None, :]
    uvw = torch.einsum("ij,tnj->tni", camera_intrinsic, p)
    return uvw[..., :2] / uvw[..., 2:3]


def project_shoulders(camera_intrinsic: Tensor, shoulder3D: Tensor, headpose_trans: Tensor,
                      ref_trans: Tensor, shoulder_amp: float) -> Tuple[Tensor, Tensor]:
    """Shoulders follow the head's translation offset scaled by
    shoulder_amp: ([T, S, 2] projected points, [T, S, 3] 3D points)."""
    diff = (headpose_trans - ref_trans[None]) * shoulder_amp
    p3d = shoulder3D[None] + diff[:, None, :]
    uvw = torch.einsum("ij,tnj->tni", camera_intrinsic, p3d)
    return uvw[..., :2] / uvw[..., 2:3], p3d
