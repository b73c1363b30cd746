"""Dataset adapters: SUNCG / Matterport3D / ScanNet pair loaders.

A copy of `relativepose_tpu/data/datasets.py` (numpy, and OpenCV for the
image files), so the port needs nothing of the JAX package: synthetic
scenes come from the port's own `data/synthetic.py`, and `batched`
stacks numpy arrays (the evaluation moves them to the device).

Host-side adapters reading the reference's on-disk layout
(datasets/SUNCG.py:243-312, Matterport3D.py, ScanNet.py):

    <base>/depth/NNNNNN.png          uint16 depth (mm; /1000 -> meters)
    <base>/rgb/NNNNNN.png            BGR color
    <base>/normal/NNNNNN.png         normals ([0,255] -> [-1,1])
    <base>/semanticLabel/NNNNNN.png  class index in channel 0 (ch 1 scannet)
    <base>/pose/NNNNNN.pose.txt      4x4 world->camera pose
    data/dataList/<list>.npy         {'train'/'test': [{'base', 'id_src',
                                      'id_tgt'}, ...]}

The adapters ONLY do file IO + decode; all per-sample math runs on the
device.  A `SyntheticPairs` source with the same interface backs tests
and benchmarks.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np

from relativepose_tpu_torch import config


def _rot_to_quaternion_np(R: np.ndarray) -> np.ndarray:
    """Host-side 3x3 -> (w,x,y,z), w>=0, by the largest-pivot method, in
    numpy so the per-item loader never dispatches device work."""
    m = R
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    cands = np.array([
        [1.0 + tr, m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]],
        [m[2, 1] - m[1, 2], 1.0 + m[0, 0] - m[1, 1] - m[2, 2],
         m[0, 1] + m[1, 0], m[0, 2] + m[2, 0]],
        [m[0, 2] - m[2, 0], m[0, 1] + m[1, 0],
         1.0 + m[1, 1] - m[0, 0] - m[2, 2], m[1, 2] + m[2, 1]],
        [m[1, 0] - m[0, 1], m[0, 2] + m[2, 0], m[1, 2] + m[2, 1],
         1.0 + m[2, 2] - m[0, 0] - m[1, 1]],
    ])
    pivots = np.array([1.0 + tr, 1.0 + m[0, 0] - m[1, 1] - m[2, 2],
                       1.0 + m[1, 1] - m[0, 0] - m[2, 2],
                       1.0 + m[2, 2] - m[0, 0] - m[1, 1]])
    q = cands[int(np.argmax(pivots))]
    q = q / (np.linalg.norm(q) + 1e-12)
    return q if q[0] >= 0 else -q

try:
    import cv2
except Exception:  # pragma: no cover - cv2 is present in the dev image
    cv2 = None


def _imread_depth(path):
    img = cv2.imread(path, 2)
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float32) / 1000.0  # SUNCG.py:83


def _imread_color(path):
    img = cv2.imread(path)  # BGR, like the reference
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float32) / 255.0


def _imread_normal(path):
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float32) / 255.0 * 2.0 - 1.0  # SUNCG.py:301


@dataclasses.dataclass
class PairRecord:
    base: str
    id_src: int
    id_tgt: int


class PanoPairDataset:
    """Common loader for the three datasets (they share the layout; only
    the semantic channel and the scannet full-frame extras differ)."""

    def __init__(self, dataset: str, split: str, list_path: str,
                 entry_split: Optional[int] = None,
                 fullsize_rgbdn: bool = False,
                 snumclass: Optional[int] = None):
        self.dataset = config.canonical_dataset(dataset)
        self.fullsize_rgbdn = fullsize_rgbdn or self.dataset == "scannet"
        self.snumclass = snumclass or config.NUM_CLASSES[self.dataset]
        raw = np.load(list_path, allow_pickle=True).item()[split]
        self.records = [
            PairRecord(r["base"], int(r["id_src"]), int(r["id_tgt"]))
            for r in raw]
        if entry_split is not None:  # evaluation sharding (SUNCG.py:68-69)
            lo, hi = entry_split * 100, (entry_split + 1) * 100
            self.records = self.records[lo:hi]

    def __len__(self):
        return len(self.records)

    def __getitem__(self, index: int) -> dict:
        rec = self.records[index]
        views = []
        for frame in (rec.id_src, rec.id_tgt):
            fid = f"{frame:06d}"
            base = rec.base
            depth = _imread_depth(os.path.join(base, "depth", f"{fid}.png"))
            rgb = _imread_color(os.path.join(base, "rgb", f"{fid}.png"))
            norm = _imread_normal(os.path.join(base, "normal", f"{fid}.png"))
            pose = np.loadtxt(
                os.path.join(base, "pose", f"{fid}.pose.txt")).reshape(4, 4)
            seg_path = os.path.join(base, "semanticLabel", f"{fid}.png")
            segm = np.zeros(depth.shape, np.int32)
            if os.path.exists(seg_path):
                seg_img = cv2.imread(seg_path)
                ch = 1 if self.dataset == "scannet" else 0  # ScanNet.py:251
                segm = seg_img[..., ch].astype(np.int32)
                segm[segm >= self.snumclass] = 0  # Matterport3D.py:237-247
            view = dict(rgb=rgb, depth=depth, norm=norm, segm=segm,
                        pose=pose.astype(np.float32))
            if self.fullsize_rgbdn:
                rf = os.path.join(base, "obs_rgb", f"{fid}.png")
                df = os.path.join(base, "obs_depth", f"{fid}.png")
                if os.path.exists(rf):
                    view["rgb_full"] = _imread_color(rf)
                    view["depth_full"] = _imread_depth(df)
            views.append(view)
        data_s, data_t = views
        T_gt = (views[1]["pose"]
                @ np.linalg.inv(views[0]["pose"])).astype(np.float32)
        q = np.zeros((2, 7), np.float32)
        for i, v in enumerate(views):
            q[i, :4] = _rot_to_quaternion_np(v["pose"][:3, :3])
            q[i, 4:] = v["pose"][:3, 3]
        return dict(data_s=data_s, data_t=data_t, T_gt=T_gt, Q=q,
                    imgs_path=(f"{rec.base}/{rec.id_src:06d}",
                               f"{rec.base}/{rec.id_tgt:06d}"))


class SyntheticPairs:
    """Synthetic drop-in with the same item contract (tests/benchmarks)."""

    def __init__(self, dataset: str = "suncg", n: int = 100, seed: int = 0,
                 max_baseline: float = 0.8, cache_size: Optional[int] = None,
                 cache_dir: Optional[str] = None,
                 view_detail_jitter: bool = False,
                 ramp_weight: float = 0.35, n_clutter: int = 0,
                 full_frames: bool = True):
        """cache_size None = cache every item in RAM (a 160x640 pair is
        ~3 MB; even 2048 pairs fit easily).  cache_dir, if set, persists
        rendered pairs as .npz so separate runs (feature training,
        completion training, eval) share one generated set.
        view_detail_jitter decorrelates the fine texture layer across the
        two views (training augmentation; see synthetic._texture).
        ramp_weight / n_clutter are the v4 scene knobs (synthetic.make_pair);
        defaults reproduce v3 scenes and reuse their cache files.
        full_frames=False skips the scannet 480x640 kinect raycast
        (training never reads rgb_full/depth_full); frameless items are
        cached under a distinct '_nf' tag, but a full cache file, if
        present, satisfies a frameless request."""
        self.dataset = dataset
        self.n = n
        self.seed = seed
        self.max_baseline = max_baseline
        self.view_detail_jitter = view_detail_jitter
        self.ramp_weight = ramp_weight
        self.n_clutter = n_clutter
        self.full_frames = full_frames
        self._cache = {}
        self._cache_size = n if cache_size is None else cache_size
        if cache_dir is None:
            cache_dir = os.environ.get("RPTPU_SYNTH_CACHE") or None
        self.cache_dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    def __len__(self):
        return self.n

    def _disk_path(self, index: int, frameless: bool = False
                   ) -> Optional[str]:
        if not self.cache_dir:
            return None
        # 'v2' = the completion-learnable texture (synthetic.py docstring);
        # v1 cache files are never reused.
        from relativepose_tpu_torch.data.synthetic import TEXTURE_VERSION
        tag = "_vj" if self.view_detail_jitter else ""
        if self.ramp_weight != 0.35:
            tag += f"_rw{self.ramp_weight:g}"
        if self.n_clutter:
            tag += f"_cl{self.n_clutter}"
        if frameless:
            tag += "_nf"
        return os.path.join(
            self.cache_dir,
            f"{self.dataset}_{self.seed + index}_{self.max_baseline:g}"
            f"_v{TEXTURE_VERSION}{tag}.npz")

    def __getitem__(self, index: int) -> dict:
        if index in self._cache:
            return self._cache[index]
        path = self._disk_path(index)
        # a full cache file satisfies a frameless request; the frameless
        # ('_nf') file never satisfies a full one
        candidates = [path] if self.full_frames else \
            [path, self._disk_path(index, frameless=True)]
        item = None
        for cand in candidates:
            if cand and os.path.exists(cand):
                try:
                    with np.load(cand) as z:
                        ds = {k[2:]: z[k] for k in z.files
                              if k.startswith("s_")}
                        dt = {k[2:]: z[k] for k in z.files
                              if k.startswith("t_")}
                        item = dict(data_s=ds, data_t=dt, T_gt=z["T_gt"],
                                    Q=None,
                                    imgs_path=(f"synthetic/{index}/src",
                                               f"synthetic/{index}/tgt"))
                    break
                except Exception:
                    item = None  # corrupt/partial file: re-render
        if item is None:
            from relativepose_tpu_torch.data import synthetic
            ds, dt, T_gt = synthetic.make_pair(
                self.seed + index, self.dataset,
                max_baseline=self.max_baseline,
                view_detail_jitter=self.view_detail_jitter,
                ramp_weight=self.ramp_weight, n_clutter=self.n_clutter,
                full_frames=self.full_frames)
            path = self._disk_path(index, frameless=not self.full_frames)
            item = dict(data_s=ds, data_t=dt, T_gt=T_gt.astype(np.float32),
                        Q=None, imgs_path=(f"synthetic/{index}/src",
                                           f"synthetic/{index}/tgt"))
            if path:
                tmp = path + f".tmp{os.getpid()}.npz"
                np.savez(tmp,
                         T_gt=item["T_gt"],
                         **{f"s_{k}": v for k, v in ds.items()},
                         **{f"t_{k}": v for k, v in dt.items()})
                os.replace(tmp, path)
        if len(self._cache) < self._cache_size:
            self._cache[index] = item
        return item


def batched(source, batch: int, fields=("rgb", "norm", "depth", "segm"),
            extra_fields=("rgb_full", "depth_full"),
            max_items: Optional[int] = None) -> Iterator:
    """Stack items into (data_s, data_t, T_gt, n_valid) batches of numpy
    arrays for the batched eval path.

    The final partial batch is PADDED to the full batch size by repeating
    the last item (so the eval fn sees one shape) and `n_valid` says how
    many leading rows are real.  `max_items` caps the number of source
    items consumed (the reference's maxIter, evaluation.py:156-158).
    """

    def stack_views(items, which):
        keys = list(fields) + [f for f in extra_fields
                               if f in items[0][which]]
        return {f: np.stack([it[which][f] for it in items]) for f in keys}

    n_src = len(source)
    if max_items is not None:
        n_src = min(n_src, max_items)
    buf = []
    for i in range(n_src):
        buf.append(source[i])
        if len(buf) == batch or i == n_src - 1:
            n_valid = len(buf)
            buf = buf + [buf[-1]] * (batch - n_valid)
            yield (stack_views(buf, "data_s"), stack_views(buf, "data_t"),
                   np.stack([it["T_gt"] for it in buf]), n_valid)
            buf = []
