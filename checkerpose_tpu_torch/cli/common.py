"""Shared CLI plumbing: config-driven dataset and loader construction and
the pretrained-backbone graft (counterpart of checkerpose_tpu/cli/common.py,
same cfg keys and path conventions: checkpoint and log dirs are
<base>/<cfg_name>/<obj_name>).

The multi-object part (the LM 13-object shared estimator and its synthetic
stand-in) keeps one table row per object, ordered by sorted obj_id:
`resolve_cfg_lm` (dirs under the shared "lm13" leaf), `load_keypoints_lm`
(the stacked keypoint and graph tables), `build_train_loaders_lm` (real
images, optionally mixed with lm_imgn renders or a second folder, with the
background swap) and the stacked branch of `attach_p3d`. The test loaders
take a {obj_id: (N, 3)} table as well as one object's keypoints.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from checkerpose_tpu_torch.config import parse_cfg
from checkerpose_tpu_torch.data.bop_io import load_models_info, scan_bop_object, scan_bop_targets
from checkerpose_tpu_torch.data.dataset import (CropDataset, Loader, MixedLoader,
                                                mixed_batch_sizes)
from checkerpose_tpu_torch.data.dataset_info import LM13_OBJECTS, get_obj_info
from checkerpose_tpu_torch.data.detections import attach_detections, load_detections
from checkerpose_tpu_torch.data.fps import load_keypoints_normed
from checkerpose_tpu_torch.data.framestore import FrameCache
from checkerpose_tpu_torch.data.lm_imgn import scan_lm_imgn
from checkerpose_tpu_torch.models.convert import graft_backbone
from checkerpose_tpu_torch.ops.geometry import pc_normalize
from checkerpose_tpu_torch.ops.knn import knn_index
from checkerpose_tpu_torch.train.checkpoint import CheckpointManager
from checkerpose_tpu_torch.train.state import TrainState


def resolve_cfg(cfg_path: str, obj_name: str, overrides: Optional[Dict] = None) -> Dict:
    cfg = parse_cfg(cfg_path)
    cfg["config_file_name"] = os.path.splitext(os.path.basename(cfg_path))[0]
    cfg["obj_name"] = obj_name
    if overrides:
        cfg.update({k: v for k, v in overrides.items() if v is not None})
    names, syms = get_obj_info(cfg["dataset_name"])
    cfg["obj_id"] = names[obj_name]
    cfg["is_symmetric"] = obj_name in syms
    for key, base in (("check_point_path", "experiments/checkpoints"),
                      ("tensorboard_path", "experiments/tensorboard_logs/runs")):
        root = cfg.get(key, base)
        cfg[key] = os.path.join(root, cfg["config_file_name"], obj_name)
    return cfg


def load_keypoints(cfg: Dict):
    """(xyz (N, 3) mm, normed (N, 3) unit ball, knn (N, K) int32)."""
    num_p3d = 2 ** int(cfg["num_p3d_log2"])
    xyz, normed = load_keypoints_normed(cfg["bop_path"], cfg["dataset_name"],
                                        cfg["obj_id"], num_p3d,
                                        cfg.get("fps_version", "fps_202212"))
    graph_k = int(cfg.get("network_graph_k", cfg.get("init_network_graph_k", 20)))
    knn = knn_index(normed, min(graph_k, len(normed)))
    return xyz, normed, knn


def _frame_cache(cfg: Dict):
    """The frame cache cfg `frame_cache_dir` names, else the dataset's own
    `frame_cache/` dir when it has one, else None."""
    cand = cfg.get("frame_cache_dir")
    if not cand or cand == "none":
        cand = os.path.join(cfg["bop_path"], cfg["dataset_name"], "frame_cache")
    if os.path.isfile(os.path.join(str(cand), "index.json")):
        return FrameCache(str(cand))
    return None


def crop_kw(cfg: Dict, crop_gt: int) -> Dict:
    return dict(crop_size_img=int(cfg.get("BoundingBox_CropSize_image", 256)),
                crop_size_gt=crop_gt,
                padding_ratio=float(cfg.get("padding_ratio", 1.5)),
                resize_method=cfg.get("resize_method", "crop_square_resize"),
                frame_cache=_frame_cache(cfg))


def build_train_loaders(cfg: Dict, xyz: np.ndarray, seed: int = 0):
    """Train loader (optionally mixing two folders at second_dataset_ratio)
    + a factory of the validation loader."""
    common = crop_kw(cfg, int(cfg.get("BoundingBox_CropSize_GT",
                                       2 ** int(cfg.get("network_res_log2", 6)))))
    vt = float(cfg.get("train_obj_visible_theshold", 0.1))
    batch = int(cfg["batch_size"])

    s1 = scan_bop_object(cfg["bop_path"], cfg["dataset_name"],
                         cfg["training_data_folder"], cfg["obj_id"], vt)
    folder2 = cfg.get("training_data_folder_2", "none")
    if folder2 and folder2 != "none":
        s2 = scan_bop_object(cfg["bop_path"], cfg["dataset_name"], folder2,
                             cfg["obj_id"], vt)
        b1, b2 = mixed_batch_sizes(batch, float(cfg.get("second_dataset_ratio", 0.75)))
        l1 = Loader(CropDataset(s1, xyz, is_train=True, seed=seed, **common),
                    b1, shuffle=True, infinite=True, seed=seed)
        l2 = Loader(CropDataset(s2, xyz, is_train=True, seed=seed + 1, **common),
                    b2, shuffle=True, infinite=True, seed=seed + 1)
        train_loader = MixedLoader(l1, l2)
    else:
        train_loader = Loader(CropDataset(s1, xyz, is_train=True, seed=seed, **common),
                              batch, shuffle=True, infinite=True, seed=seed)

    sv = scan_bop_object(cfg["bop_path"], cfg["dataset_name"],
                         cfg.get("val_folder", "test"), cfg["obj_id"], 0.1)
    val_ds = CropDataset(sv, xyz, is_train=False, **common)
    val_loader_factory = lambda: Loader(val_ds, batch, shuffle=False,  # noqa: E731
                                        drop_last=False, infinite=False)
    return train_loader, val_loader_factory


def build_test_loader(cfg: Dict, xyz: np.ndarray, batch_size: int = 16,
                      crop_gt: Optional[int] = None):
    """(single-pass loader over the test split, its samples): the BOP19
    targets with `bop_challange`, detector boxes when `Detection_reaults`
    names a file."""
    crop_gt = crop_gt or 2 ** int(cfg.get("network_res_log2", 6))
    if cfg.get("bop_challange", False):
        samples = scan_bop_targets(cfg["bop_path"], cfg["dataset_name"],
                                   cfg["obj_id"], cfg.get("test_folder", "test"))
    else:
        samples = scan_bop_object(cfg["bop_path"], cfg["dataset_name"],
                                  cfg.get("test_folder", "test"), cfg["obj_id"], 0.1)
    det_path = cfg.get("Detection_reaults", "none")
    use_det = bool(det_path) and det_path != "none"
    if use_det:
        samples = attach_detections(samples, load_detections(det_path, cfg["obj_id"]))
    ds = CropDataset(samples, xyz, is_train=False, use_detections=use_det,
                     **crop_kw(cfg, crop_gt))
    return Loader(ds, batch_size, shuffle=False, drop_last=False, infinite=False), samples


def build_val_slice_loader_factory(cfg: Dict, xyz: np.ndarray, *,
                                   max_images: int = 32,
                                   batch_size: int = 16,
                                   crop_gt: Optional[int] = None):
    """Factory of a loader over a small held-out slice (the first
    `max_images` of `calib_folder`, GT boxes) for decode-tau calibration;
    `calib_folder` defaults to val_folder, then test_folder, but should
    name a training split so tau is not tuned on the images it is quoted on."""
    crop_gt = crop_gt or 2 ** int(cfg.get("network_res_log2", 6))
    samples = scan_bop_object(
        cfg["bop_path"], cfg["dataset_name"],
        cfg.get("calib_folder", cfg.get("val_folder", cfg.get("test_folder", "test"))),
        cfg["obj_id"], 0.1)[:max_images]
    ds = CropDataset(samples, xyz, is_train=False, use_detections=False,
                     **crop_kw(cfg, crop_gt))

    def factory():
        return Loader(ds, batch_size, shuffle=False, drop_last=False, infinite=False)

    return factory


def attach_p3d(batch: Dict, p3dn: np.ndarray) -> Dict:
    """Attach per-sample normalized keypoints: a stacked (O, N, 3) table is
    gathered by `obj_idx`, one object's (N, 3) is broadcast."""
    if p3dn.ndim == 3:
        batch["p3d_normed"] = p3dn[np.asarray(batch["obj_idx"])]
    else:
        B = batch["image"].shape[0]
        batch["p3d_normed"] = np.broadcast_to(p3dn[None], (B,) + p3dn.shape).copy()
    return batch


def with_p3d(loader, p3dn: np.ndarray):
    for batch in loader:
        yield attach_p3d(batch, p3dn)


def solver_kwargs(cfg: Dict) -> Dict:
    """The reference's solver flags mapped onto this solver's knobs:
    reprojErr_thresh -> reproj_thresh; under --use_progressivex the soft
    inliers and the spatial-coherence diffusion (weight, radius); the
    sequential iteration caps -> num_hyp, the parallel hypothesis count
    (an explicit pnp_num_hyp wins)."""
    use_px = bool(cfg.get("use_progressivex", False))
    max_iters = cfg.get("prog_max_iters") if use_px else cfg.get("cv_max_iters")
    return dict(
        num_hyp=int(cfg.get("pnp_num_hyp") or max_iters or 128),
        reproj_thresh=float(cfg.get("pnp_reproj_thresh")
                            or cfg.get("reprojErr_thresh") or 2.0),
        soft_inlier_sigma=(0.5 if use_px else 0.0),
        coherence_weight=(float(cfg.get("spatial_coherence_weight") or 0.1)
                          if use_px else 0.0),
        neighborhood_radius=float(cfg.get("nbr_ball_radius") or 20.0),
    )


def checkpoint_dir_arg(ckpt_dir, ckpt_file):
    """--ckpt_dir, with --ckpt_file accepted as the reference CLI's alias; a
    file path degrades to its directory."""
    ckpt = ckpt_dir or ckpt_file
    if ckpt and os.path.isfile(ckpt):
        ckpt = os.path.dirname(ckpt)
    return ckpt


def object_diameter(cfg: Dict) -> float:
    info = load_models_info(cfg["bop_path"], cfg["dataset_name"], eval_models=False)
    return float(info[cfg["obj_id"]]["diameter"])


# ---------------------------------------------------------------------------
# multi-object (LM 13-object shared estimator)
# ---------------------------------------------------------------------------

def resolve_cfg_lm(cfg_path: str, overrides: Optional[Dict] = None) -> Dict:
    """LM config: one shared estimator over several objects (default the 13
    Linemod ones; cfg `obj_names` as a list or a comma- or space-separated
    string). Adds obj_names, obj_ids, symmetric_names; checkpoint and log
    dirs are <base>/<cfg_name>/lm13; `datasets_root` stands in for a
    missing bop_path, as in the reference's LM configs."""
    cfg = parse_cfg(cfg_path)
    cfg["config_file_name"] = os.path.splitext(os.path.basename(cfg_path))[0]
    if overrides:
        cfg.update({k: v for k, v in overrides.items() if v is not None})
    cfg.setdefault("dataset_name", "lm")
    if "bop_path" not in cfg and "datasets_root" in cfg:
        cfg["bop_path"] = cfg["datasets_root"]
    names, syms = get_obj_info(cfg["dataset_name"])
    obj_names = cfg.get("obj_names")
    if isinstance(obj_names, str):
        obj_names = [n for n in obj_names.replace(",", " ").split() if n]
    cfg["obj_names"] = list(obj_names or LM13_OBJECTS)
    cfg["obj_ids"] = [names[n] for n in cfg["obj_names"]]
    cfg["symmetric_names"] = set(syms)
    for key, base in (("check_point_path", "experiments/checkpoints"),
                      ("tensorboard_path", "experiments/tensorboard_logs/runs")):
        root = cfg.get(key, base)
        cfg[key] = os.path.join(root, cfg["config_file_name"], "lm13")
    return cfg


def load_keypoints_lm(cfg: Dict):
    """({obj_id: (N, 3)} mm, p3d_normed (O, N, 3), knn (O, N, K) int32),
    rows ordered by sorted obj_id, the order CropDataset gives obj_idx."""
    num_p3d = 2 ** int(cfg["num_p3d_log2"])
    graph_k = int(cfg.get("network_graph_k", cfg.get("init_network_graph_k", 20)))
    table, normed_rows, knn_rows = {}, [], []
    for obj_id in sorted(cfg["obj_ids"]):
        xyz = load_keypoints_normed(cfg["bop_path"], cfg["dataset_name"], obj_id, num_p3d,
                                    cfg.get("fps_version", "fps_202212"))[0]
        table[obj_id] = xyz
        normed = pc_normalize(xyz.astype(np.float64)).astype(np.float32)
        normed_rows.append(normed)
        knn_rows.append(knn_index(normed, min(graph_k, num_p3d)))
    return table, np.stack(normed_rows), np.stack(knn_rows)


def _background_paths(cfg: Dict):
    """The sorted .jpg / .jpeg / .png files of cfg voc_background_root (else
    background_root), or None when it names no directory."""
    bg_root = cfg.get("voc_background_root") or cfg.get("background_root")
    if not bg_root or not os.path.isdir(str(bg_root)):
        return None
    return sorted(os.path.join(bg_root, f) for f in os.listdir(bg_root)
                  if f.lower().endswith((".jpg", ".png", ".jpeg")))


def build_train_loaders_lm(cfg: Dict, p3d_table: Dict, seed: int = 0):
    """The multi-object train loader over every object's
    training_data_folder, mixed at second_dataset_ratio with
    training_data_folder_2 (`lm_imgn`: the lm_imgn renders under
    lm_imgn_root, imgn_n_per_obj an object) when one is named, with the
    background swap of bg_paths / change_bg_prob; and a factory of one
    object's validation loader, `factory(obj_id)`."""
    common_kw = crop_kw(cfg, int(cfg.get("BoundingBox_CropSize_GT",
                                          2 ** int(cfg.get("network_res_log2", 6)))))
    vt = float(cfg.get("train_obj_visible_theshold", 0.1))
    batch = int(cfg["batch_size"])
    train_kw = dict(common_kw, is_train=True, bg_paths=_background_paths(cfg),
                    change_bg_prob=float(cfg.get("change_bg_prob", 0.0)))

    def gather(folder):
        return [s for obj_id in sorted(cfg["obj_ids"])
                for s in scan_bop_object(cfg["bop_path"], cfg["dataset_name"], folder,
                                         obj_id, vt)]

    def gather_imgn():
        id_to_name = {oid: n for n, oid in zip(cfg["obj_names"], cfg["obj_ids"])}
        n_per = int(cfg.get("imgn_n_per_obj", 1000))
        return [s for obj_id in sorted(cfg["obj_ids"])
                for s in scan_lm_imgn(cfg["lm_imgn_root"], id_to_name[obj_id], obj_id,
                                      n_per_obj=n_per)]

    s1 = gather(cfg["training_data_folder"])
    folder2 = cfg.get("training_data_folder_2", "none")
    if folder2 == "lm_imgn" and cfg.get("lm_imgn_root"):
        s2 = gather_imgn()
    elif folder2 and folder2 != "none":
        s2 = gather(folder2)
    else:
        s2 = None
    if s2:
        b1, b2 = mixed_batch_sizes(batch, float(cfg.get("second_dataset_ratio", 0.75)))
        l1 = Loader(CropDataset(s1, p3d_table, seed=seed, **train_kw), b1, shuffle=True,
                    infinite=True, seed=seed)
        l2 = Loader(CropDataset(s2, p3d_table, seed=seed + 1, **train_kw), b2, shuffle=True,
                    infinite=True, seed=seed + 1)
        train_loader = MixedLoader(l1, l2)
    else:
        train_loader = Loader(CropDataset(s1, p3d_table, seed=seed, **train_kw), batch,
                              shuffle=True, infinite=True, seed=seed)

    def val_loader_factory(obj_id):
        sv = scan_bop_object(cfg["bop_path"], cfg["dataset_name"],
                             cfg.get("val_folder", "test"), obj_id, 0.1)
        return Loader(CropDataset(sv, p3d_table, is_train=False, **common_kw), batch,
                      shuffle=False, drop_last=False, infinite=False)

    return train_loader, val_loader_factory


def maybe_graft_pretrained_backbone(cfg: Dict, state: TrainState) -> TrainState:
    """Graft a pretrained backbone into a fresh InitNet state when cfg
    `backbone_pretrain_checkpoint` names a checkpoint dir: the `backbone.*`
    entries of its latest checkpoint's model go into `state.module` in place,
    validated entry by entry (models/convert.py::graft_backbone). The NOCS
    pretraining CLI (cli/pretrain_backbone.py) writes such checkpoints; an
    InitNet checkpoint has the same backbone entries. It stands in for the
    reference's ImageNet-pretrained timm weights (`model/backbone.py:39-50`),
    which need a network. Only at step 0: a resumed run already carries its
    further-trained backbone.

    A dir with no checkpoint trains the backbone from scratch with a warning,
    or raises FileNotFoundError under CHECKERPOSE_REQUIRE_BACKBONE_GRAFT=1."""
    bk_ck = cfg.get("backbone_pretrain_checkpoint")
    if not bk_ck or int(state.step) != 0:
        return state
    strict = os.environ.get("CHECKERPOSE_REQUIRE_BACKBONE_GRAFT", "0") == "1"
    # existence is checked on the filesystem first: a CheckpointManager at a
    # mistyped path would create the directory, which hides the mistake
    has_step = os.path.isdir(bk_ck) and any(d.isdigit() for d in os.listdir(bk_ck))
    if not has_step:
        msg = f"backbone_pretrain_checkpoint={bk_ck} has no numbered checkpoint step"
        if strict:
            # for runs where the graft carries the result: a silent
            # from-scratch run would void them without any failure
            raise FileNotFoundError(msg + " and CHECKERPOSE_REQUIRE_BACKBONE_GRAFT=1")
        # otherwise fail soft, so a scheduler that restarts the run is not
        # caught in a retry loop: train from scratch, loudly
        print(f"WARNING: {msg}; training the backbone from scratch", flush=True)
        return state
    mgr = CheckpointManager(bk_ck)
    if mgr.latest_step() is None:
        if strict:
            raise FileNotFoundError(f"backbone_pretrain_checkpoint={bk_ck}: no restorable "
                                    "step (CHECKERPOSE_REQUIRE_BACKBONE_GRAFT=1)")
        print(f"WARNING: backbone_pretrain_checkpoint={bk_ck} has no checkpoint; "
              "training the backbone from scratch", flush=True)
        return state
    raw = mgr.restore_raw()
    backbone = {k[len("backbone."):]: v for k, v in raw["model"].items()
                if k.startswith("backbone.")}
    state.module.load_state_dict(graft_backbone(state.module.state_dict(), backbone, into=""))
    print(f"grafted NOCS-pretrained backbone from {bk_ck} (step {int(raw['step'])})",
          flush=True)
    return TrainState(module=state.module, optimizer=state.optimizer, step=0,
                      best_score=state.best_score)
