"""SE(3) rigid transforms over PyTorch tensors, in full float32.

Counterpart of the JAX package's ``geometry/rigid.py`` (reference
src/mdgen/rigid_utils.py:282,813). Rotations are (..., 3, 3) matrices,
translations (..., 3); quaternions are scalar-first (w, x, y, z) for the
7-tensor latent encoding (quat4 ‖ trans3).

Every product here is written as broadcast multiplies and sums, never as a
matrix-multiply call, so no TF32 path can touch the geometry on a GPU (the
JAX package pins ``Precision.HIGHEST`` for the same reason). The entry points
also switch TF32 off (``full_f32``).
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch


def full_f32() -> None:
    """Keep float32 products in full float32 on the GPU (TF32 off for both
    matmuls and cuDNN): the geometry and the f32 reference paths need it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., i, j) x (..., j, k) -> (..., i, k) by exact f32 sums."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _matvec(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., i, j) x (..., j) -> (..., i)."""
    return (a * v[..., None, :]).sum(-1)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Unit-norm-insensitive quaternion (..., 4) to rotation matrix."""
    w, x, y, z = quat.unbind(-1)
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rows = [
        [ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotmat_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix to unit quaternion, branch-free Shepperd construction
    (the candidate with the largest trace term wins); sign is arbitrary."""
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    qw = torch.stack([1.0 + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], -1)
    traces = torch.stack([1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    best = traces.argmax(-1)
    cand = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 candidates, 4)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cand, -2, idx)[..., 0, :]
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of scalar-first quaternions (..., 4)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


class Rigid:
    """A batch of SE(3) transforms: ``rot`` (..., 3, 3) and ``trans`` (..., 3)."""

    __slots__ = ("rot", "trans")

    def __init__(self, rot: torch.Tensor, trans: torch.Tensor):
        self.rot = rot
        self.trans = trans

    @staticmethod
    def identity(shape: Tuple[int, ...], dtype=torch.float32, device=None) -> "Rigid":
        """Identity transforms of batch ``shape``."""
        rot = torch.eye(3, dtype=dtype, device=device).expand(*shape, 3, 3)
        return Rigid(rot, torch.zeros(*shape, 3, dtype=dtype, device=device))

    @staticmethod
    def from_quat_trans(quat: torch.Tensor, trans: torch.Tensor,
                        normalize: bool = True) -> "Rigid":
        """From scalar-first quaternions (..., 4), normalised unless told
        not to, and translations (..., 3)."""
        if normalize:
            quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
        return Rigid(quat_to_rotmat(quat), trans)

    @staticmethod
    def from_tensor_7(t7: torch.Tensor, normalize_quats: bool = True) -> "Rigid":
        return Rigid.from_quat_trans(t7[..., :4], t7[..., 4:], normalize=normalize_quats)

    @staticmethod
    def from_tensor_4x4(m: torch.Tensor) -> "Rigid":
        return Rigid(m[..., :3, :3], m[..., :3, 3])

    @staticmethod
    def from_3_points(p_neg_x_axis, origin, p_xy_plane, eps: float = 1e-8) -> "Rigid":
        """Gram-Schmidt frame (AF2 algorithm 21); columns (e0, e1, e2), e0 from
        ``p_neg_x_axis`` to ``origin``, e1 toward ``p_xy_plane``."""
        e0 = origin - p_neg_x_axis
        e1 = p_xy_plane - origin
        e0 = e0 / torch.sqrt((e0 * e0).sum(-1, keepdim=True) + eps)
        e1 = e1 - e0 * (e0 * e1).sum(-1, keepdim=True)
        e1 = e1 / torch.sqrt((e1 * e1).sum(-1, keepdim=True) + eps)
        e2 = torch.linalg.cross(e0, e1, dim=-1)
        return Rigid(torch.stack([e0, e1, e2], dim=-1), origin)

    def compose(self, other: "Rigid") -> "Rigid":
        return Rigid(_matmul(self.rot, other.rot),
                     _matvec(self.rot, other.trans) + self.trans)

    def invert(self) -> "Rigid":
        rot_inv = self.rot.transpose(-1, -2)
        return Rigid(rot_inv, -_matvec(rot_inv, self.trans))

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        return _matvec(self.rot, pts) + self.trans

    def invert_apply(self, pts: torch.Tensor) -> torch.Tensor:
        return _matvec(self.rot.transpose(-1, -2), pts - self.trans)

    def to_tensor_7(self) -> torch.Tensor:
        return torch.cat([rotmat_to_quat(self.rot), self.trans], dim=-1)

    def to_tensor_4x4(self) -> torch.Tensor:
        """Homogeneous matrices (..., 4, 4)."""
        m = torch.zeros(*self.rot.shape[:-2], 4, 4, dtype=self.rot.dtype, device=self.rot.device)
        m[..., :3, :3] = self.rot
        m[..., :3, 3] = self.trans
        m[..., 3, 3] = 1.0
        return m

    def scale_translation(self, factor) -> "Rigid":
        return Rigid(self.rot, self.trans * factor)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.trans.shape[:-1])

    def __getitem__(self, idx) -> "Rigid":
        """Index over batch dims only."""
        if not isinstance(idx, tuple):
            idx = (idx,)
        return Rigid(self.rot[idx + (slice(None), slice(None))],
                     self.trans[idx + (slice(None),)])

    def unsqueeze(self, dim: int) -> "Rigid":
        rd = dim if dim >= 0 else dim - 2
        td = dim if dim >= 0 else dim - 1
        return Rigid(self.rot.unsqueeze(rd), self.trans.unsqueeze(td))

    @staticmethod
    def cat(rigids: Sequence["Rigid"], dim: int) -> "Rigid":
        rd = dim if dim >= 0 else dim - 2
        td = dim if dim >= 0 else dim - 1
        return Rigid(torch.cat([r.rot for r in rigids], dim=rd),
                     torch.cat([r.trans for r in rigids], dim=td))


@functools.lru_cache(maxsize=None)
def rigid_vecs_flip(device=None) -> torch.Tensor:
    """diag(-1, 1, -1) used to flip backbone frames (src/mdgen/geometry.py:227-230);
    made once per device and shared by every caller: never write into it."""
    return torch.diag(torch.tensor([-1.0, 1.0, -1.0], device=device))
