"""Ray generation and NDC geometry (port of `nsff_pl_tpu/ops/rays.py`).

Conventions as in the JAX package: camera space is "right up back"
(rays look down -z), no +0.5 pixel centering, and the NDC cube maps the
frustum from the near plane to z in [0, 1] after the origin shift.
"""
from __future__ import annotations

import torch


def _k(K, device=None) -> torch.Tensor:
    return torch.as_tensor(K, dtype=torch.float32, device=device)


def get_ray_directions(H: int, W: int, K, flatten: bool = True,
                       return_uv: bool = False, device=None):
    """Per-pixel camera-space directions d = ((i-cx)/fx, -(j-cy)/fy, -1).

    Returns (H*W, 3) (or (H, W, 3) if not flatten), plus the (u, v) pixel
    grid if `return_uv`."""
    K = _k(K, device)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=K.device),
        torch.arange(W, dtype=torch.float32, device=K.device), indexing="ij")
    directions = torch.stack([(i - cx) / fx, -(j - cy) / fy,
                              -torch.ones_like(i)], -1)
    grid = torch.stack([i, j], -1)
    if flatten:
        directions = directions.reshape(-1, 3)
        grid = grid.reshape(-1, 2)
    if return_uv:
        return directions, grid
    return directions


def get_rays(directions: torch.Tensor, c2w):
    """World-space ray origins and unit directions; `c2w` is (3, 4)."""
    c2w = torch.as_tensor(c2w, dtype=directions.dtype,
                          device=directions.device)
    rays_d = directions @ c2w[:, :3].T
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = c2w[:, 3].expand(rays_d.shape)
    return rays_o, rays_d


def get_ndc_rays(K, near, shift_near, rays_o: torch.Tensor,
                 rays_d: torch.Tensor):
    """Project world rays into NDC with origins shifted to the near plane.
    `near`/`shift_near` may be scalars or per-ray (N,) tensors."""
    K = _k(K, rays_o.device)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    t = -(shift_near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]

    o0 = -1.0 / (cx / fx) * ox_oz
    o1 = -1.0 / (cy / fy) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (cx / fx) * (rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -1.0 / (cy / fy) * (rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2

    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def world2ndc(xyz: torch.Tensor, K) -> torch.Tensor:
    """World -> NDC coordinates of (..., 3) points, intrinsics (3, 3)."""
    K = _k(K, xyz.device)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    ndc_x = -fx / cx * xyz[..., 0] / xyz[..., 2]
    ndc_y = -fy / cy * xyz[..., 1] / xyz[..., 2]
    ndc_z = 1 + 2 / xyz[..., 2]
    return torch.stack([ndc_x, ndc_y, ndc_z], -1)


def ndc2world(xyz: torch.Tensor, K, eps: float = 1e-6) -> torch.Tensor:
    """NDC -> world coordinates. `K` is (3, 3), or (N, 3, 3) matched
    against an (N, ..., 3) `xyz`."""
    K = _k(K, xyz.device)
    fx, fy, cx, cy = K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]
    if K.ndim == 3 and xyz.ndim == 3:
        fx, fy, cx, cy = (v[:, None] for v in (fx, fy, cx, cy))
    rz = 2.0 / (xyz[..., 2] - 1 - eps)
    rx = -rz * xyz[..., 0] * cx / fx
    ry = -rz * xyz[..., 1] * cy / fy
    return torch.stack([rx, ry, rz], -1)


def compute_world_visibility(xyz_w: torch.Tensor, K, H: int, W: int,
                             c2ws) -> torch.Tensor:
    """How many of the cameras `c2ws` ((C, 3, 4) camera-to-world poses,
    intrinsics `K`, H x W images) see each of the (N, 3) world points:
    (N,) float counts, 0 for a point inside no frustum."""
    dt = xyz_w.dtype  # float32 (float64 points: in float64)
    K = _k(K, xyz_w.device).to(dt)
    c2ws = torch.as_tensor(c2ws, dtype=dt, device=xyz_w.device)
    C = c2ws.shape[0]
    c2w4 = torch.eye(4, dtype=dt, device=xyz_w.device).repeat(C, 1, 1)
    c2w4[:, :3] = c2ws
    # inv_ex: no host check for a singular input, so a CUDA graph
    # captures it
    w2c = torch.linalg.inv_ex(c2w4)[0]
    R, t = w2c[:, :3, :3], w2c[:, :3, 3]
    xyz_cam = torch.einsum("cij,nj->cni", R, xyz_w) + t[:, None]
    in_front = xyz_cam[..., 2] < 0  # front is the negative z axis
    # flip to "right down front" for the projection (no host-made
    # constant: graph-capturable)
    xyz_proj = torch.cat([xyz_cam[..., :1], -xyz_cam[..., 1:]], -1)
    uvd = torch.einsum("ij,cnj->cni", K, xyz_proj)
    d = uvd[..., 2]
    denom = torch.where(d.abs() < 1e-8, torch.sign(d) * 1e-8 + 1e-12, d)
    u, v = uvd[..., 0] / denom, uvd[..., 1] / denom
    inside = (u >= 0) & (u < W) & (v >= 0) & (v < H) & in_front
    return inside.float().sum(0)
