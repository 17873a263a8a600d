"""Host-side (numpy) data transforms of the flagship training, validation
and test pipelines (the port's copy of the part of
``scenesplat_tpu/data/transforms.py`` that
``configs/concat_dataset/lang-pretrain-concat-gs-contrastive.py`` and the
fragment test pipeline of ``configs/_base_/gs_pipelines.py`` use).

All transforms run in numpy on the host and draw from a per-thread
generator that the loader seeds per sample (``seed_transforms``), so
augmentation is a pure function of (seed, epoch, sample index). 3DGS
behaviour is kept: rotations and flips also transform the wxyz quaternion,
RandomScale scales the per-Gaussian ``scale``, GridSample keeps the FNV-1a
voxel hash, SphereCrop crops every per-point key including ``lang_feat``.
"""

from __future__ import annotations

import copy
import threading
from collections.abc import Sequence

import numpy as np

from scenesplat_tpu_torch.utils.registry import Registry

TRANSFORMS = Registry("transforms")

# Per-thread transform RNG: the loaders run dataset fetches on a thread pool,
# and a process-global RNG would make the draw-to-sample assignment depend on
# thread scheduling.
_TLS = threading.local()


def seed_transforms(entropy) -> None:
    """Seed this thread's transform RNG; ``entropy`` is an int or tuple."""
    if not isinstance(entropy, (tuple, list)):
        entropy = (int(entropy),)
    _TLS.rng = np.random.default_rng(
        np.random.SeedSequence([int(e) & (2**63 - 1) for e in entropy])
    )


def trng() -> np.random.Generator:
    """This thread's transform RNG (fresh OS-entropy generator if unseeded)."""
    rng = getattr(_TLS, "rng", None)
    if rng is None:
        rng = _TLS.rng = np.random.default_rng()
    return rng

# keys indexed per-point in the working resolution (pc_* / origin_* keys hold
# the separate full-resolution point cloud and are never cropped with these)
PER_POINT_KEYS = (
    "coord",
    "color",
    "normal",
    "strength",
    "segment",
    "instance",
    "quat",
    "scale",
    "opacity",
    "lang_feat",
    "valid_feat_mask",
    "grid_coord",
    "displacement",
    "index",
)


def _subset(data_dict, idx):
    n = data_dict["coord"].shape[0]
    for key in PER_POINT_KEYS:
        value = data_dict.get(key)
        if isinstance(value, np.ndarray) and value.shape[:1] == (n,):
            data_dict[key] = value[idx]
    return data_dict


def _rotation_matrix(axis: str, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    if axis == "z":
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    raise NotImplementedError(axis)

def _matrix_to_quat_wxyz(m):
    # Shepperd's method, vectorized
    t = np.trace(m, axis1=1, axis2=2)
    q = np.zeros((m.shape[0], 4))
    c0 = t > 0
    s = np.sqrt(np.maximum(t[c0] + 1.0, 0)) * 2
    q[c0, 0] = 0.25 * s
    q[c0, 1] = (m[c0, 2, 1] - m[c0, 1, 2]) / np.maximum(s, 1e-12)
    q[c0, 2] = (m[c0, 0, 2] - m[c0, 2, 0]) / np.maximum(s, 1e-12)
    q[c0, 3] = (m[c0, 1, 0] - m[c0, 0, 1]) / np.maximum(s, 1e-12)
    rest = ~c0
    if rest.any():
        mm = m[rest]
        qq = np.zeros((mm.shape[0], 4))
        d = np.stack([mm[:, 0, 0], mm[:, 1, 1], mm[:, 2, 2]], -1)
        i = d.argmax(-1)
        for ii in range(3):
            sel = i == ii
            if not sel.any():
                continue
            a, b, c = ii, (ii + 1) % 3, (ii + 2) % 3
            ms = mm[sel]
            s = np.sqrt(np.maximum(1.0 + ms[:, a, a] - ms[:, b, b] - ms[:, c, c], 0)) * 2
            s = np.maximum(s, 1e-12)
            qq[sel, 0] = (ms[:, c, b] - ms[:, b, c]) / s
            qq[sel, 1 + a] = 0.25 * s
            qq[sel, 1 + b] = (ms[:, b, a] + ms[:, a, b]) / s
            qq[sel, 1 + c] = (ms[:, c, a] + ms[:, a, c]) / s
        q[rest] = qq
    return q


def _normalize_quat(q):
    n = np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    return q / n


def _rotate_quat(data_dict, rot_t):
    """Left-multiply the per-Gaussian rotation by ``rot_t``
    (reference transform.py:582-595; scipy composes unit quaternions, so
    this is one batched Hamilton product on the normalized quats — the
    matrix round-trip costs ~30x more host time at 700k Gaussians)."""
    if "quat" not in data_dict:
        return
    q = _normalize_quat(np.asarray(data_dict["quat"], np.float64))
    rw, rx, ry, rz = _matrix_to_quat_wxyz(rot_t[None])[0]
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    data_dict["quat"] = np.stack(
        [
            rw * w - rx * x - ry * y - rz * z,
            rw * x + rx * w + ry * z - rz * y,
            rw * y - rx * z + ry * w + rz * x,
            rw * z + rx * y - ry * x + rz * w,
        ],
        axis=-1,
    ).astype(np.float32)

class Compose:
    def __init__(self, cfg=None):
        self.transforms = [
            t if callable(t) else TRANSFORMS.build(t) for t in (cfg or [])
        ]

    def __call__(self, data_dict):
        for t in self.transforms:
            data_dict = t(data_dict)
        return data_dict


@TRANSFORMS.register_module()
class Collect:
    """Pick keys + concat feat_keys into 'feat' (reference transform.py:320-354).
    No 'offset' is emitted — batching uses masks, not packed offsets."""

    def __init__(self, keys, **kwargs):
        self.keys = (keys,) if isinstance(keys, str) else keys
        self.kwargs = kwargs

    def __call__(self, data_dict):
        data = dict()
        for key in self.keys:
            if key in data_dict:
                data[key] = data_dict[key]
        for name, keys in self.kwargs.items():
            name = name.replace("_keys", "")
            assert isinstance(keys, Sequence)
            data[name] = np.concatenate(
                [np.atleast_2d(np.asarray(data_dict[key], np.float32).T).T
                 if np.asarray(data_dict[key]).ndim == 1
                 else np.asarray(data_dict[key], np.float32)
                 for key in keys],
                axis=1,
            )
        return data

@TRANSFORMS.register_module()
class Copy:
    def __init__(self, keys_dict=None):
        self.keys_dict = keys_dict or dict(coord="origin_coord", segment="origin_segment")

    def __call__(self, data_dict):
        for key, value in self.keys_dict.items():
            if key in data_dict:
                v = data_dict[key]
                data_dict[value] = v.copy() if isinstance(v, np.ndarray) else copy.deepcopy(v)
        return data_dict


@TRANSFORMS.register_module()
class HostConvPlan:
    """Accepted and does nothing. In the JAX package it builds the stem's
    k=5 conv plan on the host, because the TPU's on-device builders hit
    compile limits at scene extents; the port builds every conv plan on the
    card with one sort + searchsorted builder
    (``ops/subm_conv.py:build_subm_conv_plan``), so no host plan is needed."""

    def __init__(self, kernel_size=5, extent=(320, 320, 320)):
        self.kernel_size = int(kernel_size)
        self.extent = tuple(int(e) for e in extent)

    def __call__(self, data_dict):
        return data_dict


@TRANSFORMS.register_module()
class ToTensor:
    """Kept for config compatibility; arrays stay numpy on the host."""

    def __call__(self, data):
        return data


@TRANSFORMS.register_module()
class NormalizeColor:
    def __call__(self, data_dict):
        if "color" in data_dict:
            data_dict["color"] = data_dict["color"] / 127.5 - 1
        return data_dict


@TRANSFORMS.register_module()
class CenterShift:
    def __init__(self, apply_z=True):
        self.apply_z = apply_z

    def __call__(self, data_dict):
        if "coord" in data_dict:
            x_min, y_min, z_min = data_dict["coord"].min(axis=0)
            x_max, y_max, _ = data_dict["coord"].max(axis=0)
            z = z_min if self.apply_z else 0
            shift = np.array([(x_min + x_max) / 2, (y_min + y_max) / 2, z])
            data_dict["coord"] = data_dict["coord"] - shift
            if "pc_coord" in data_dict:
                data_dict["pc_coord"] = data_dict["pc_coord"] - shift
        return data_dict


@TRANSFORMS.register_module()
class RandomDropout:
    def __init__(self, dropout_ratio=0.2, dropout_application_ratio=0.5):
        self.dropout_ratio = dropout_ratio
        self.dropout_application_ratio = dropout_application_ratio

    def __call__(self, data_dict):
        if trng().random() < self.dropout_application_ratio:
            n = len(data_dict["coord"])
            idx = trng().choice(n, int(n * (1 - self.dropout_ratio)), replace=False)
            _subset(data_dict, idx)
        return data_dict


@TRANSFORMS.register_module()
class RandomRotate:
    def __init__(self, angle=None, center=None, axis="z", always_apply=False, p=0.5):
        self.angle = [-1, 1] if angle is None else angle
        self.axis = axis
        self.p = 1 if always_apply else p
        self.center = center

    def __call__(self, data_dict):
        if trng().random() > self.p:
            return data_dict
        angle = trng().uniform(self.angle[0], self.angle[1]) * np.pi
        return _apply_rotation(data_dict, self.axis, angle, self.center)


@TRANSFORMS.register_module()
class RandomRotateTargetAngle:
    def __init__(self, angle=(1 / 2, 1, 3 / 2), center=None, axis="z",
                 always_apply=False, p=0.75):
        self.angle = angle
        self.axis = axis
        self.p = 1 if always_apply else p
        self.center = center

    def __call__(self, data_dict):
        if trng().random() > self.p:
            return data_dict
        angle = trng().choice(self.angle) * np.pi
        return _apply_rotation(data_dict, self.axis, angle, self.center)


def _apply_rotation(data_dict, axis, angle, center):
    rot_t = _rotation_matrix(axis, angle)
    if "coord" in data_dict:
        if center is None:
            lo = data_dict["coord"].min(axis=0)
            hi = data_dict["coord"].max(axis=0)
            center = (lo + hi) / 2
        center = np.asarray(center)
        data_dict["coord"] = (data_dict["coord"] - center) @ rot_t.T + center
        if "pc_coord" in data_dict:
            data_dict["pc_coord"] = (data_dict["pc_coord"] - center) @ rot_t.T + center
    _rotate_quat(data_dict, rot_t)
    if "normal" in data_dict:
        data_dict["normal"] = data_dict["normal"] @ rot_t.T
    return data_dict


@TRANSFORMS.register_module()
class RandomScale:
    def __init__(self, scale=None, anisotropic=False):
        self.scale = scale if scale is not None else [0.95, 1.05]
        self.anisotropic = anisotropic

    def __call__(self, data_dict):
        if "coord" in data_dict:
            scale = trng().uniform(
                self.scale[0], self.scale[1], 3 if self.anisotropic else 1
            )
            data_dict["coord"] = data_dict["coord"] * scale
            if "pc_coord" in data_dict:
                data_dict["pc_coord"] = data_dict["pc_coord"] * scale
            if "scale" in data_dict:
                data_dict["scale"] = data_dict["scale"] * scale
        return data_dict


@TRANSFORMS.register_module()
class RandomFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, data_dict):
        r_reflect = np.eye(3)
        flipped = False
        for axis in (0, 1):
            if trng().random() < self.p:
                reflect = np.eye(3)
                reflect[axis, axis] = -1
                r_reflect = reflect @ r_reflect
                flipped = True
                if "coord" in data_dict:
                    data_dict["coord"][:, axis] = -data_dict["coord"][:, axis]
                if "pc_coord" in data_dict:
                    data_dict["pc_coord"][:, axis] = -data_dict["pc_coord"][:, axis]
                if "normal" in data_dict:
                    data_dict["normal"][:, axis] = -data_dict["normal"][:, axis]
        if flipped and "quat" in data_dict:
            # conjugate the rotation by the reflection (reference l.714-725).
            # F R(u, t) F = R(F u, -t) for a single-axis reflection F, i.e.
            # (w, v) -> (w, -F v): negating the two vector components other
            # than the flipped axis. Quaternion sign is ambiguous (goldens
            # compare matrices); the reference normalizes via scipy, so do.
            q = _normalize_quat(np.asarray(data_dict["quat"], np.float64))
            signs = np.ones(4)
            for axis in (0, 1):
                if r_reflect[axis, axis] < 0:
                    others = [a for a in (0, 1, 2) if a != axis]
                    signs[[1 + others[0], 1 + others[1]]] *= -1.0
            data_dict["quat"] = (q * signs).astype(np.float32)
        return data_dict


@TRANSFORMS.register_module()
class RandomJitter:
    def __init__(self, sigma=0.01, clip=0.05):
        assert clip > 0
        self.sigma = sigma
        self.clip = clip

    def __call__(self, data_dict):
        if "coord" in data_dict:
            jitter = np.clip(
                self.sigma * trng().standard_normal((data_dict["coord"].shape[0], 3)),
                -self.clip, self.clip,
            )
            data_dict["coord"] = data_dict["coord"] + jitter
        return data_dict


@TRANSFORMS.register_module()
class ElasticDistortion:
    def __init__(self, distortion_params=None):
        self.distortion_params = (
            [[0.2, 0.4], [0.8, 1.6]] if distortion_params is None
            else distortion_params
        )

    @staticmethod
    def elastic_distortion(coords, granularity, magnitude):
        """Smooth random warp (reference transform.py:1121-1170 semantics):
        a coarse lattice of Gaussian noise — one node per ``granularity``
        cube, two rounds of a separable 3-tap box blur — is trilinearly
        interpolated at every point and added, scaled by ``magnitude``."""
        import scipy.ndimage
        import scipy.interpolate

        lo = coords.min(0)
        span = (coords - lo).max(0)
        lattice_dim = (span // granularity).astype(int) + 3
        lattice = trng().standard_normal((*lattice_dim, 3)).astype(np.float32)
        tap3 = np.full(3, 1.0 / 3.0, np.float32)
        for _ in range(2):
            for axis in range(3):
                lattice = scipy.ndimage.correlate1d(
                    lattice, tap3, axis=axis, mode="constant", cval=0
                )
        node_axes = [
            np.linspace(
                lo[d] - granularity,
                lo[d] + granularity * (lattice_dim[d] - 2),
                lattice_dim[d],
            )
            for d in range(3)
        ]
        warp = scipy.interpolate.RegularGridInterpolator(
            node_axes, lattice, bounds_error=False, fill_value=0
        )
        return coords + warp(coords) * magnitude

    def __call__(self, data_dict):
        if "coord" in data_dict and self.distortion_params is not None:
            if trng().random() < 0.95:
                for granularity, magnitude in self.distortion_params:
                    data_dict["coord"] = self.elastic_distortion(
                        data_dict["coord"], granularity, magnitude
                    )
        return data_dict


@TRANSFORMS.register_module()
class ChromaticAutoContrast:
    def __init__(self, p=0.2, blend_factor=None):
        self.p = p
        self.blend_factor = blend_factor

    def __call__(self, data_dict):
        if "color" in data_dict and trng().random() < self.p:
            lo = np.min(data_dict["color"], 0, keepdims=True)
            hi = np.max(data_dict["color"], 0, keepdims=True)
            scale = 255 / np.maximum(hi - lo, 1e-6)
            contrast = (data_dict["color"][:, :3] - lo) * scale
            blend = trng().random() if self.blend_factor is None else self.blend_factor
            data_dict["color"][:, :3] = (
                (1 - blend) * data_dict["color"][:, :3] + blend * contrast
            )
        return data_dict


@TRANSFORMS.register_module()
class ChromaticTranslation:
    def __init__(self, p=0.95, ratio=0.05):
        self.p = p
        self.ratio = ratio

    def __call__(self, data_dict):
        if "color" in data_dict and trng().random() < self.p:
            tr = (trng().random((1, 3)) - 0.5) * 255 * 2 * self.ratio
            data_dict["color"][:, :3] = np.clip(tr + data_dict["color"][:, :3], 0, 255)
        return data_dict


@TRANSFORMS.register_module()
class ChromaticJitter:
    def __init__(self, p=0.95, std=0.005):
        self.p = p
        self.std = std

    def __call__(self, data_dict):
        if "color" in data_dict and trng().random() < self.p:
            noise = trng().standard_normal((data_dict["color"].shape[0], 3)) * self.std * 255
            data_dict["color"][:, :3] = np.clip(
                noise + data_dict["color"][:, :3], 0, 255
            )
        return data_dict


@TRANSFORMS.register_module()
class SphereCrop:
    """Crop to at most point_max points around a random/center point
    (reference transform.py:1420+)."""

    def __init__(self, point_max=80000, sample_rate=None, mode="random"):
        self.point_max = point_max
        self.sample_rate = sample_rate
        assert mode in ["random", "center", "all"]
        self.mode = mode

    def __call__(self, data_dict):
        point_max = (
            int(self.sample_rate * data_dict["coord"].shape[0])
            if self.sample_rate is not None
            else self.point_max
        )
        assert "coord" in data_dict
        n = data_dict["coord"].shape[0]
        if n <= point_max or self.mode == "all":
            return data_dict
        if self.mode == "random":
            center = data_dict["coord"][int(trng().integers(n))]
        else:
            center = data_dict["coord"][n // 2]
        d2 = np.sum(np.square(data_dict["coord"] - center), 1)
        # reference: np.argsort(d2)[:point_max]. Same selection + same
        # distance-sorted order via O(n) partition of only the kept subset
        part = np.argpartition(d2, point_max - 1)[:point_max]
        idx = part[np.argsort(d2[part])]
        return _subset(data_dict, idx)


def fnv_hash_vec(arr: np.ndarray) -> np.ndarray:
    """FNV64-1A over integer coordinate rows (reference transform.py:1402-1416)."""
    assert arr.ndim == 2
    arr = arr.astype(np.uint64, copy=True)
    hashed = np.uint64(14695981039346656037) * np.ones(arr.shape[0], dtype=np.uint64)
    for j in range(arr.shape[1]):
        hashed *= np.uint64(1099511628211)
        hashed = np.bitwise_xor(hashed, arr[:, j])
    return hashed


@TRANSFORMS.register_module()
class GridSample:
    """Voxel grid sampling. Cells are grouped by the FNV-1a hash of their
    integer coordinates. Train mode: one uniformly random point per occupied
    cell. Test mode: as many complementary fragments as the fullest cell has
    points, each covering every occupied cell once. A full-resolution
    evaluation point cloud (``pc_coord``) is subsampled to one point per
    cell, labeled points first, unless ``apply_to_pc`` is off.

    This is the JAX package's numpy path of GridSample; in train mode its
    host C++ reservoir sampler (``scenesplat_tpu/native``) draws from
    another random stream, so the two pick different, equally distributed
    points."""

    def __init__(self, grid_size=0.05, hash_type="fnv", mode="train",
                 keys=("coord", "color", "normal", "segment"), return_inverse=False,
                 return_grid_coord=False, return_min_coord=False, apply_to_pc=True):
        if mode not in ("train", "test"):
            raise ValueError(f"GridSample mode {mode!r}")
        if hash_type != "fnv":
            raise NotImplementedError(f"GridSample hash {hash_type} is not ported")
        self.grid_size = grid_size
        self.mode = mode
        self.keys = keys
        self.return_inverse = return_inverse
        self.return_grid_coord = return_grid_coord
        self.return_min_coord = return_min_coord
        self.apply_to_pc = apply_to_pc

    def __call__(self, data_dict):
        assert "coord" in data_dict
        scaled = data_dict["coord"] / np.asarray(self.grid_size)
        cell = np.floor(scaled).astype(int)
        origin = cell.min(0)
        cell = cell - origin
        origin_world = origin * np.asarray(self.grid_size)
        if "pc_coord" in data_dict and self.apply_to_pc:
            self._sample_pc(data_dict)
        # group points into cells: sort by hashed cell id (numpy's default
        # sort kind, as the JAX package: test-mode fragment membership
        # follows its tie order), mark the head of each run
        n = cell.shape[0]
        cell_hash = fnv_hash_vec(cell)
        order = np.argsort(cell_hash)
        sorted_hash = cell_hash[order]
        run_head = np.ones(n, dtype=bool)
        run_head[1:] = sorted_hash[1:] != sorted_hash[:-1]
        starts = np.flatnonzero(run_head)
        sizes = np.diff(np.append(starts, n))

        def point_to_cell():
            out = np.empty(n, dtype=np.int64)
            out[order] = np.cumsum(run_head) - 1
            return out

        if self.mode == "train":
            jitter = trng().integers(0, sizes.max(), sizes.shape[0]) % sizes
            picked = order[starts + jitter]
            if self.return_inverse:
                data_dict["inverse"] = point_to_cell()
            if self.return_grid_coord:
                data_dict["grid_coord"] = cell[picked]
            if self.return_min_coord:
                data_dict["min_coord"] = origin_world.reshape([1, 3])
            for k in self.keys:
                if k in data_dict:
                    data_dict[k] = data_dict[k][picked]
            return data_dict

        # test mode: fragment p takes the (p mod size)-th member of every
        # cell. Each key is gathered into sorted order once and the
        # fragments slice it with increasing positions.
        num_frags = int(sizes.max())
        gathered = {k: data_dict[k][order] for k in data_dict
                    if k in self.keys and num_frags > 1}
        cell_sorted = cell[order] if (self.return_grid_coord and num_frags > 1) else None
        fragments = []
        for p in range(num_frags):
            pos = starts + p % sizes
            member = order[pos]
            frag = dict(index=member)
            if self.return_inverse:
                data_dict["inverse"] = point_to_cell()
            if self.return_grid_coord:
                frag["grid_coord"] = cell_sorted[pos] if cell_sorted is not None else cell[member]
            if self.return_min_coord:
                frag["min_coord"] = origin_world.reshape([1, 3])
            for k in data_dict:
                if k in self.keys:
                    frag[k] = gathered[k][pos] if k in gathered else data_dict[k][member]
                else:
                    frag[k] = data_dict[k]
            fragments.append(frag)
        return fragments

    def _sample_pc(self, data_dict):
        """Subsample the evaluation point cloud to one point per cell, the
        cell's first labeled point where it has one."""
        pc_grid = np.floor(data_dict["pc_coord"] / np.asarray(self.grid_size)).astype(int)
        pc_grid -= pc_grid.min(0)
        pc_key = fnv_hash_vec(pc_grid)
        pc_segment = data_dict.get("pc_segment", None)
        if pc_segment is not None:
            unlabeled = (np.asarray(pc_segment) == -1).astype(np.uint8)
            pc_idx_sort = np.lexsort((unlabeled, pc_key))
        else:
            pc_idx_sort = np.argsort(pc_key, kind="stable")
        pc_key_sorted = pc_key[pc_idx_sort]
        first_idx = np.nonzero(
            np.concatenate(([True], pc_key_sorted[1:] != pc_key_sorted[:-1])))[0]
        chosen = np.asarray(pc_idx_sort[first_idx], dtype=np.int64)
        data_dict["pc_coord"] = data_dict["pc_coord"][chosen]
        if "pc_segment" in data_dict:
            data_dict["pc_segment"] = data_dict["pc_segment"][chosen]
