"""Host-side (numpy) data transforms of the flagship training, validation
and test pipelines (the port's copy of the part of
``scenesplat_tpu/data/transforms.py`` that
``configs/concat_dataset/lang-pretrain-concat-gs-contrastive.py`` and the
fragment test pipeline of ``configs/_base_/gs_pipelines.py`` use).

The SSL files' multi-crop pipeline is here too: the colour jitter,
grayscale and solarize transforms, ``SphereCropRandomMaxPoints``,
``ContrastiveViewsGenerator_SSL``, ``CollectContrast`` and the opacity-masked
voxel blur ``GSGaussianBlurVoxelOpc`` (scipy's ``gaussian_filter`` on the
host, as the JAX package runs it). Masked Scene Contrast's two views
come from ``ContrastiveViewsGenerator``, with ``RandomColorDrop``,
``HueSaturationTranslation`` and ``ShufflePoint`` of its view pipeline.
The object and outdoor pipelines' ``NormalizeCoord``, ``PositiveShift``,
``RandomShift``, ``PointClip``, ``ClipGaussianJitter``, ``CropBoundary``
and the box-kernel colour blur ``GSGaussianBlurVoxelGPU`` (scipy's
``uniform_filter`` on the host) complete the JAX package's set.

All transforms run in numpy on the host and draw from a per-thread
generator that the loader seeds per sample (``seed_transforms``), so
augmentation is a pure function of (seed, epoch, sample index). 3DGS
behaviour is kept: rotations and flips also transform the wxyz quaternion,
RandomScale scales the per-Gaussian ``scale``, GridSample keeps the FNV-1a
voxel hash (or the ravel one), SphereCrop crops every per-point key including ``lang_feat``.
"""

from __future__ import annotations

import copy
import numbers
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


def _subset(data_dict, idx, keys=PER_POINT_KEYS):
    n = data_dict["coord"].shape[0]
    for key in keys:
        value = data_dict.get(key)
        if isinstance(value, np.ndarray) and value.shape[:1] == (n,):
            data_dict[key] = value[idx]
    return data_dict


# an MSC view's pre-augmentation coordinates follow its points through the
# view's crops and shuffles (ContrastiveViewsGenerator)
VIEW_POINT_KEYS = PER_POINT_KEYS + ("origin_coord",)


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
class Add:
    """Sets each of ``keys_dict``'s keys to its value (Point Prompt
    Training's per-dataset ``condition``)."""

    def __init__(self, keys_dict=None):
        self.keys_dict = keys_dict or dict()

    def __call__(self, data_dict):
        data_dict.update(self.keys_dict)
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
class InstanceParser:
    """Instance targets for instance segmentation (reference
    transform.py:1621-1663): points of a ``segment_ignore_index`` class lose
    their instance; the others' ids are compacted to 0..I-1 (``instance``);
    ``instance_centroid`` [N, 3] is each point's instance's mean coordinate
    (``instance_ignore_index`` without one); ``bbox`` [I, 8] is each
    instance's centre, extent, 0 and class, counted without the ignored
    classes below it. ``bbox`` is one row an instance, not a point, so
    collation drops it."""

    def __init__(self, segment_ignore_index=(-1, 0, 1), instance_ignore_index=-1):
        self.segment_ignore_index = segment_ignore_index
        self.instance_ignore_index = instance_ignore_index

    def __call__(self, data_dict):
        coord = data_dict["coord"]
        segment = data_dict["segment"]
        instance = np.asarray(data_dict["instance"]).copy()
        mask = ~np.isin(segment, self.segment_ignore_index)
        instance[~mask] = self.instance_ignore_index
        unique, inverse = np.unique(instance[mask], return_inverse=True)
        instance_num = len(unique)
        instance[mask] = inverse
        centroid = np.full((coord.shape[0], 3), self.instance_ignore_index, np.float64)
        bbox = np.full((instance_num, 8), self.instance_ignore_index, np.float64)
        vacancy = [i for i in self.segment_ignore_index if i >= 0]
        for inst_id in range(instance_num):
            m = instance == inst_id
            c = coord[m]
            bmin, bmax = c.min(0), c.max(0)
            cls = np.array([segment[m][0]], dtype=np.float64)
            cls -= np.greater(cls, vacancy).sum()
            centroid[m] = c.mean(0)
            bbox[inst_id] = np.concatenate([(bmax + bmin) / 2, bmax - bmin, np.zeros(1), cls])
        data_dict["instance"] = instance
        data_dict["instance_centroid"] = centroid
        data_dict["bbox"] = bbox
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
class NormalizeCoord:
    """Coordinates centred on their mean and scaled into the unit ball (by
    the largest norm); a per-Gaussian ``scale`` scales with them."""

    def __call__(self, data_dict):
        if "coord" in data_dict:
            data_dict["coord"] = data_dict["coord"] - np.mean(data_dict["coord"], axis=0)
            m = np.max(np.sqrt(np.sum(data_dict["coord"] ** 2, axis=1)))
            data_dict["coord"] = data_dict["coord"] / m
            if "scale" in data_dict:
                data_dict["scale"] = data_dict["scale"] / m
        return data_dict


@TRANSFORMS.register_module()
class PositiveShift:
    """Coordinates shifted so that each axis starts at 0."""

    def __call__(self, data_dict):
        if "coord" in data_dict:
            data_dict["coord"] = data_dict["coord"] - np.min(data_dict["coord"], 0)
        return data_dict


@TRANSFORMS.register_module()
class RandomShift:
    """Coordinates shifted by one draw of U(lo, hi) an axis; ``shift`` is
    three (lo, hi) pairs, or three magnitudes s for (-s, s)."""

    def __init__(self, shift=((-0.2, 0.2), (-0.2, 0.2), (0, 0))):
        if len(shift) == 3 and isinstance(shift[0], (int, float)):
            shift = tuple((-s, s) for s in shift)
        self.shift = shift

    def __call__(self, data_dict):
        if "coord" in data_dict:
            s = [trng().uniform(lo, hi) for lo, hi in self.shift]
            data_dict["coord"] = data_dict["coord"] + np.asarray(s)
        return data_dict


@TRANSFORMS.register_module()
class PointClip:
    """Coordinates clipped into ``point_cloud_range`` (x, y, z minima, then
    maxima)."""

    def __init__(self, point_cloud_range=(-80, -80, -3, 80, 80, 1)):
        self.point_cloud_range = point_cloud_range

    def __call__(self, data_dict):
        if "coord" in data_dict:
            data_dict["coord"] = np.clip(data_dict["coord"], a_min=self.point_cloud_range[:3],
                                         a_max=self.point_cloud_range[3:])
        return data_dict


@TRANSFORMS.register_module()
class RandomDropout:
    subset_keys = PER_POINT_KEYS

    def __init__(self, dropout_ratio=0.2, dropout_application_ratio=0.5):
        self.dropout_ratio = dropout_ratio
        self.dropout_application_ratio = dropout_application_ratio

    def __call__(self, data_dict):
        if trng().random() < self.dropout_application_ratio:
            n = len(data_dict["coord"])
            idx = trng().choice(n, int(n * (1 - self.dropout_ratio)), replace=False)
            _subset(data_dict, idx, self.subset_keys)
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
class ClipGaussianJitter:
    """Each point moved by ``scalar`` times a standard normal draw over 1.96,
    clipped to [-1, 1] (``store_jitter`` keeps the offsets as ``jitter``)."""

    def __init__(self, scalar=0.02, store_jitter=False):
        self.scalar = scalar
        self.store_jitter = store_jitter

    def __call__(self, data_dict):
        if "coord" in data_dict:
            jitter = trng().multivariate_normal(np.zeros(3), np.identity(3),
                                                data_dict["coord"].shape[0])
            jitter = self.scalar * np.clip(jitter / 1.96, -1, 1)
            data_dict["coord"] = data_dict["coord"] + jitter
            if self.store_jitter:
                data_dict["jitter"] = jitter
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
class CropBoundary:
    """Drops the points labeled 0 (a dataset's boundary class)."""

    def __call__(self, data_dict):
        if "segment" not in data_dict:
            raise KeyError("CropBoundary needs a segment")
        return _subset(data_dict, np.nonzero(data_dict["segment"] != 0)[0])


@TRANSFORMS.register_module()
class SphereCrop:
    """Crop to at most point_max points around a random/center point
    (reference transform.py:1420+)."""

    subset_keys = PER_POINT_KEYS

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
        return _subset(data_dict, idx, self.subset_keys)


def fnv_hash_vec(arr: np.ndarray) -> np.ndarray:
    """FNV64-1A over integer coordinate rows (reference transform.py:1402-1416)."""
    assert arr.ndim == 2
    arr = arr.astype(np.uint64, copy=True)
    hashed = np.uint64(14695981039346656037) * np.ones(arr.shape[0], dtype=np.uint64)
    for j in range(arr.shape[1]):
        hashed *= np.uint64(1099511628211)
        hashed = np.bitwise_xor(hashed, arr[:, j])
    return hashed


def ravel_hash_vec(arr: np.ndarray) -> np.ndarray:
    """Row-major rank of integer coordinate rows in the box they span (each
    axis shifted to start at 0): distinct cells get distinct keys."""
    assert arr.ndim == 2
    arr = arr - arr.min(0)
    arr = arr.astype(np.uint64, copy=False)
    arr_max = arr.max(0).astype(np.uint64) + 1
    keys = np.zeros(arr.shape[0], dtype=np.uint64)
    for j in range(arr.shape[1] - 1):
        keys += arr[:, j]
        keys *= arr_max[j + 1]
    keys += arr[:, -1]
    return keys


@TRANSFORMS.register_module()
class GridSample:
    """Voxel grid sampling. Cells are grouped by the FNV-1a hash of their
    integer coordinates (``hash_type="fnv"``) or by their row-major rank
    (``"ravel"``); the two order cells, and so a test mode's fragments,
    differently. Train mode: one uniformly random point per occupied
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
        self.hash = fnv_hash_vec if hash_type == "fnv" else ravel_hash_vec
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
        cell_hash = self.hash(cell)
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
        pc_key = self.hash(pc_grid)
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


@TRANSFORMS.register_module()
class RandomColorGrayScale:
    def __init__(self, p):
        self.p = p

    def __call__(self, data_dict):
        if "color" in data_dict and trng().random() < self.p:
            r, g, b = (data_dict["color"][..., i] for i in range(3))
            gray = (0.2989 * r + 0.587 * g + 0.114 * b).astype(data_dict["color"].dtype)
            data_dict["color"] = np.broadcast_to(gray[..., None],
                                                 data_dict["color"].shape).copy()
        return data_dict


@TRANSFORMS.register_module()
class RandomColorSolarize:
    """Inverts colours at or above ``threshold``, written back (the
    reference's version drops its result; the JAX package fixes that)."""

    def __init__(self, p=0.2, threshold=128):
        self.p = p
        self.threshold = threshold

    def __call__(self, data_dict):
        if "color" in data_dict and trng().random() < self.p:
            color = data_dict["color"]
            data_dict["color"] = np.where(color < self.threshold, color, 255 - color)
        return data_dict


@TRANSFORMS.register_module()
class RandomColorDrop:
    """Scales the colours by ``color_augment`` (0: drops them) with
    probability ``p`` (reference transform.py, MSC's view pipeline)."""

    def __init__(self, p=0.2, color_augment=0.0):
        self.p = p
        self.color_augment = color_augment

    def __call__(self, data_dict):
        if "color" in data_dict and trng().random() < self.p:
            data_dict["color"] = data_dict["color"] * self.color_augment
        return data_dict


@TRANSFORMS.register_module()
class ShufflePoint:
    """Permutes the points (every per-point key; in an MSC view
    ``origin_coord`` too, see ContrastiveViewsGenerator)."""

    subset_keys = PER_POINT_KEYS

    def __call__(self, data_dict):
        idx = trng().permutation(data_dict["coord"].shape[0])
        return _subset(data_dict, idx, self.subset_keys)


def _rgb_to_hsv(rgb):
    """Vectorized colorsys.rgb_to_hsv over [..., 3] arrays: h and s in
    [0, 1], v the raw largest channel."""
    rgb = rgb.astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.max(axis=-1)
    minc = rgb.min(axis=-1)
    span = maxc - minc
    safe = np.where(span == 0, 1.0, span)
    s = np.where(maxc == 0, 0.0, span / np.where(maxc == 0, 1.0, maxc))
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = np.select([span == 0, r == maxc, g == maxc], [0.0, bc - gc, 2.0 + rc - bc],
                  default=4.0 + gc - rc)
    h = (h / 6.0) % 1.0
    return np.stack([h, s, maxc], axis=-1)


def _hsv_to_rgb(hsv):
    """Vectorized colorsys.hsv_to_rgb; v carries the original value scale."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0).astype(np.int64) % 6
    f = (h * 6.0) - np.floor(h * 6.0)
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    conditions = [s == 0.0, i == 1, i == 2, i == 3, i == 4, i == 5]
    r = np.select(conditions, [v, q, p, p, t, v], default=v)
    g = np.select(conditions, [v, v, v, q, p, p], default=t)
    b = np.select(conditions, [v, p, t, v, v, q], default=p)
    return np.stack([r, g, b], axis=-1)


@TRANSFORMS.register_module()
class HueSaturationTranslation:
    """Random hue rotation and saturation scaling in HSV space over RGB
    colours in [0, 255] (reference transform.py:1043-1109)."""

    def __init__(self, hue_max=0.5, saturation_max=0.2):
        self.hue_max = hue_max
        self.saturation_max = saturation_max

    def __call__(self, data_dict):
        if "color" in data_dict:
            color = np.asarray(data_dict["color"])
            hsv = _rgb_to_hsv(color[:, :3])
            hue_val = (trng().random() - 0.5) * 2 * self.hue_max
            sat_ratio = 1 + (trng().random() - 0.5) * 2 * self.saturation_max
            hsv[..., 0] = (hsv[..., 0] + hue_val) % 1.0
            hsv[..., 1] = np.clip(sat_ratio * hsv[..., 1], 0, 1)
            data_dict["color"][:, :3] = np.clip(_hsv_to_rgb(hsv), 0, 255).astype(color.dtype)
        return data_dict


@TRANSFORMS.register_module()
class RandomColorJitter:
    """torchvision-style colour jitter over RGB in [0, 255]: brightness,
    contrast, saturation and hue factors drawn first, then applied in a
    random order, each with probability ``p``."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, p=0.95):
        self.brightness = self._check_input(brightness, "brightness")
        self.contrast = self._check_input(contrast, "contrast")
        self.saturation = self._check_input(saturation, "saturation")
        self.hue = self._check_input(hue, "hue", center=0, bound=(-0.5, 0.5),
                                     clip_first_on_zero=False)
        self.p = p

    @staticmethod
    def _check_input(value, name, center=1, bound=(0, float("inf")),
                     clip_first_on_zero=True):
        if isinstance(value, numbers.Number):
            if value < 0:
                raise ValueError(f"{name} must be non-negative")
            value = [center - value, center + value]
            if clip_first_on_zero:
                value[0] = max(value[0], 0.0)
        elif isinstance(value, (tuple, list)) and len(value) == 2:
            if not bound[0] <= value[0] <= value[1] <= bound[1]:
                raise ValueError(f"{name} values should be between {bound}")
        else:
            raise TypeError(f"{name} should be a number or a pair")
        if value[0] == value[1] == center:
            value = None
        return value

    @staticmethod
    def _blend(color1, color2, ratio):
        return (ratio * color1 + (1.0 - ratio) * color2).clip(0, 255.0).astype(color1.dtype)

    @staticmethod
    def _grayscale(color):
        r, g, b = color[..., 0], color[..., 1], color[..., 2]
        return (0.2989 * r + 0.587 * g + 0.114 * b)[..., None]

    def __call__(self, data_dict):
        if "color" not in data_dict:
            return data_dict
        factors = {
            0: None if self.brightness is None else trng().uniform(*self.brightness),
            1: None if self.contrast is None else trng().uniform(*self.contrast),
            2: None if self.saturation is None else trng().uniform(*self.saturation),
            3: None if self.hue is None else trng().uniform(*self.hue),
        }
        for fn_id in trng().permutation(4):
            f = factors[int(fn_id)]
            if f is None or trng().random() >= self.p:
                continue
            color = data_dict["color"]
            if fn_id == 0:  # brightness
                color = self._blend(color, np.zeros_like(color), f)
            elif fn_id == 1:  # contrast
                color = self._blend(color, self._grayscale(color).mean(), f)
            elif fn_id == 2:  # saturation
                color = self._blend(color, self._grayscale(color), f)
            else:  # hue
                orig_dtype = color.dtype
                hsv = _rgb_to_hsv(color.astype(np.float64) / 255.0)
                hsv[..., 0] = (hsv[..., 0] + f) % 1.0
                color = (_hsv_to_rgb(hsv) * 255.0).clip(0, 255).astype(orig_dtype)
            data_dict["color"] = color
        return data_dict


@TRANSFORMS.register_module()
class SphereCropRandomMaxPoints:
    """SphereCrop with a random budget: a ``random_scale=(lo, hi)`` share of
    ``point_max`` (of the point count without it), or else an absolute
    ``max_points=(lo, hi)`` range."""

    def __init__(self, max_points=None, random_scale=None, point_max=None, mode="random"):
        self.max_points = max_points
        self.random_scale = random_scale
        self.point_max = point_max
        self.mode = mode

    def __call__(self, data_dict):
        if self.random_scale is not None:
            scale = trng().uniform(*self.random_scale)
            budget = int(scale * (self.point_max or data_dict["coord"].shape[0]))
        else:
            lo, hi = self.max_points or (80000, 120000)
            budget = int(trng().integers(lo, hi + 1))
        return SphereCrop(point_max=max(budget, 1), mode=self.mode)(data_dict)


@TRANSFORMS.register_module()
class ContrastiveViewsGenerator:
    """Two views for MSC-style contrastive pretraining (reference
    transform.py:1596-1618): the same transform stack applied to two
    copies of ``view_keys``, outputs prefixed ``view1_`` and ``view2_``,
    view 1's draws first. A view's ``origin_coord`` (its points'
    coordinates before the view's augmentation) follows its points through
    the stack's crops, dropouts and shuffles, as it does through a
    GridSample whose ``keys`` name it. The JAX package's transforms leave
    it behind (ROADMAP Queue 3), so a cropped or shuffled view pairs its
    points with other points' origins there."""

    def __init__(self, view_keys=("coord", "color", "normal", "origin_coord"),
                 view_trans_cfg=None):
        self.view_keys = view_keys
        self.view_trans = Compose(view_trans_cfg)
        for t in self.view_trans.transforms:
            if hasattr(t, "subset_keys"):
                t.subset_keys = VIEW_POINT_KEYS

    def __call__(self, data_dict):
        for prefix in ("view1_", "view2_"):
            view = self.view_trans({k: np.copy(data_dict[k]) for k in self.view_keys
                                    if k in data_dict})
            for key, value in view.items():
                data_dict[prefix + key] = value
        return data_dict


@TRANSFORMS.register_module()
class ContrastiveViewsGenerator_SSL:
    """Multi-crop views for SimDINO pretraining: a global base transform
    feeds two differently augmented global crops, a local base transform
    feeds ``local_crop_num`` local crops; outputs are prefixed
    ``global_crop{0,1}_`` and ``local_crop{i}_``. The draws happen in that
    order: global base, global 0, global 1, local base, each local."""

    def __init__(self, view_keys=("coord", "color", "normal", "origin_coord"),
                 global_base_transform=None, local_base_transform=None,
                 global_transform0=None, global_transform1=None, local_transform=None,
                 local_crop_num=4):
        self.view_keys = view_keys
        self.global_base_transform = Compose(global_base_transform)
        self.local_base_transform = Compose(local_base_transform)
        self.global_transform0 = Compose(global_transform0)
        self.global_transform1 = Compose(global_transform1)
        self.local_transform = Compose(local_transform)
        self.local_crop_num = local_crop_num

    def __call__(self, data_dict):
        def clone(src):
            return {k: np.copy(src[k]) for k in self.view_keys if k in src}

        global_base = self.global_base_transform(clone(data_dict))
        views = {"global_crop0": self.global_transform0(clone(global_base)),
                 "global_crop1": self.global_transform1(clone(global_base))}
        local_base = self.local_base_transform(clone(data_dict))
        for i in range(self.local_crop_num):
            views[f"local_crop{i}"] = self.local_transform(clone(local_base))
        for prefix, view in views.items():
            for key, value in view.items():
                data_dict[f"{prefix}_{key}"] = value
        return data_dict


@TRANSFORMS.register_module()
class CollectContrast:
    """Keeps the keys that start with one of ``keys_prefix`` and, for each
    ``<name>_keys`` argument, concatenates those keys' columns into
    ``<name>`` (fp32). ``offset_keys_dict`` (the reference's per-crop point
    counts) is accepted and emits nothing: the padded batches carry each
    crop's ``mask``. The JAX package's CollectContrast reads it as a list of
    feature keys and raises KeyError on the shipped SSL pipeline."""

    def __init__(self, keys_prefix, offset_keys_dict=None, **kwargs):
        self.keys_prefix = [keys_prefix] if isinstance(keys_prefix, str) else list(keys_prefix)
        self.kwargs = kwargs

    def __call__(self, data_dict):
        data = {k: v for k, v in data_dict.items() if k.startswith(tuple(self.keys_prefix))}
        for name, keys in self.kwargs.items():
            data[name.replace("_keys", "")] = np.concatenate(
                [np.asarray(data_dict[k], np.float32).reshape(len(data_dict[k]), -1)
                 for k in keys], axis=1)
        return data


@TRANSFORMS.register_module()
class GSGaussianBlurVoxelOpc:
    """Opacity-masked voxel blur of 3DGS attributes: the Gaussians of
    opacity above 0.5 are put into a dense grid of their ``grid_coord``
    cells, their colour (and ``extra_keys``) and an occupancy weight are
    blurred together by a Gaussian of sigma ~ U(sigma[0], sigma[1]) cells
    (truncated at 2 sigma), and each of them reads back its cell's
    blurred values over the blurred weight. Quaternions are renormalized,
    every row of them."""

    def __init__(self, p=0.5, sigma=(0.1, 2, 0), extra_keys=()):
        self.p = p
        self.sigma = sigma
        self.extra_keys = tuple(extra_keys or ())

    def __call__(self, data_dict):
        if trng().random() >= self.p:
            return data_dict
        import scipy.ndimage

        if "grid_coord" not in data_dict:
            raise KeyError("GSGaussianBlurVoxelOpc needs GridSample(return_grid_coord=True)")
        grid_coord = data_dict["grid_coord"]
        opacity = np.asarray(data_dict["opacity"]).reshape(-1)
        sigma = trng().uniform(self.sigma[0], self.sigma[1])
        blur_mask = opacity > 0.5
        if not blur_mask.any():
            return data_dict
        gmin = grid_coord.min(axis=0)
        gsize = grid_coord.max(axis=0) - gmin + 1
        idx = tuple((grid_coord[blur_mask] - gmin).astype(int).T)

        keys = ["color"] + [k for k in self.extra_keys if k in data_dict]
        channels, slices, start = [], {}, 0
        for k in keys:
            v = np.asarray(data_dict[k], np.float32)
            v = v.reshape(len(v), -1)
            channels.append(v[blur_mask])
            slices[k] = slice(start, start + v.shape[1])
            start += v.shape[1]
        values = np.concatenate(channels + [np.ones((blur_mask.sum(), 1), np.float32)], axis=1)
        grid = np.zeros((*gsize, values.shape[1]), np.float32)
        grid[idx] = values
        blurred = scipy.ndimage.gaussian_filter(grid, sigma=sigma, truncate=2.0,
                                                axes=(0, 1, 2))
        picked = blurred[idx]
        weights = picked[:, -1:] + 1e-7
        for k in keys:
            out = np.asarray(data_dict[k], np.float32).copy()
            flat = out.reshape(len(out), -1)
            flat[blur_mask] = picked[:, slices[k]] / weights
            if k == "quat":
                flat /= np.maximum(np.linalg.norm(flat, axis=1, keepdims=True), 1e-9)
            data_dict[k] = flat.reshape(np.asarray(data_dict[k]).shape)
        return data_dict


@TRANSFORMS.register_module()
class GSGaussianBlurVoxelGPU:
    """Box-kernel voxel blur of the colour: with probability ``p``, every
    Gaussian's colour and an occupancy weight go into a dense grid of its
    ``grid_coord`` cells, a uniform filter of 2 r + 1 cells (r =
    round(4 sigma), sigma ~ U(sigma[0], sigma[1]); none at r = 0) blurs
    them, and each Gaussian reads back its cell's colour over its weight.
    The reference runs it in torch on the card; the port, as the JAX
    package, on the host with scipy."""

    def __init__(self, p=0.5, sigma=(0.1, 2, 0)):
        self.p = p
        self.sigma = sigma

    def __call__(self, data_dict):
        if trng().random() >= self.p:
            return data_dict
        import scipy.ndimage

        if "grid_coord" not in data_dict:
            raise KeyError("GSGaussianBlurVoxelGPU needs GridSample(return_grid_coord=True)")
        grid_coord = np.asarray(data_dict["grid_coord"])
        color = np.asarray(data_dict["color"], np.float32)
        radius = round(4.0 * trng().uniform(self.sigma[0], self.sigma[1]))
        if radius <= 0:
            return data_dict
        gmin = grid_coord.min(axis=0)
        gsize = grid_coord.max(axis=0) - gmin + 1
        idx = tuple((grid_coord - gmin).astype(int).T)
        grid = np.zeros((*gsize, color.shape[1] + 1), np.float32)
        grid[idx] = np.concatenate([color, np.ones((len(color), 1), np.float32)], axis=1)
        picked = scipy.ndimage.uniform_filter(grid, size=2 * radius + 1, axes=(0, 1, 2),
                                              mode="constant")[idx]
        data_dict["color"] = (picked[:, :-1] / (picked[:, -1:] + 1e-7)).astype(
            data_dict["color"].dtype)
        return data_dict
