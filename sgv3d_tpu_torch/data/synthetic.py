"""Synthetic roadside batches with physically consistent calibration, and a
fake on-disk dataset tree (numpy; a jax-free copy of
`sgv3d_tpu.data.synthetic`, bitwise equal for the same seed)."""
from __future__ import annotations

import numpy as np

from sgv3d_tpu_torch import geom
from sgv3d_tpu_torch.config import ExpConfig


def make_calibration(rng: np.random.Generator, final_dim, orig_hw=(1080, 1920),
                     cam_height: float = 7.0, pitch_deg: float = 12.0):
    """Build a consistent (sensor2ego, sensor2virtual, intrin, ida, ref_h)."""
    pitch = np.deg2rad(pitch_deg + rng.normal(0, 1.0))
    # camera axes: x right (ego -y), y down-forward, z forward (ego x)
    R_cam2ego = (np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], float)
                 @ geom.rodrigues(np.array([pitch, 0, 0])).T)
    s2e = np.eye(4, dtype=np.float32)
    s2e[:3, :3] = R_cam2ego
    s2e[:3, 3] = [0, 0, cam_height + rng.normal(0, 0.2)]
    denorm = geom.get_denorm(np.linalg.inv(s2e.astype(np.float64)))
    s2v = geom.get_sensor2virtual(denorm)
    ref_h = geom.get_reference_height(denorm)

    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 2100.0 + rng.normal(0, 50)
    K[0, 2] = orig_hw[1] / 2
    K[1, 2] = orig_hw[0] / 2
    resize = final_dim[1] / orig_hw[1]
    crop_top = int(orig_hw[0] * resize) - final_dim[0]
    ida = geom.ida_matrix(
        resize, (0, crop_top, final_dim[1], int(orig_hw[0] * resize)),
        False, 0.0)
    return s2e, s2v.astype(np.float32), K, ida.astype(np.float32), ref_h


def make_batch(cfg: ExpConfig, batch: int, seed: int = 0, num_objs: int = 12,
               max_objs: int | None = None):
    """Returns (sweep_imgs, mats, gt_boxes, gt_labels, gt_semantic) as numpy.

    sweep_imgs: (B, 1, 1, H, W, 3) normalised images (NHWC).
    mats: dict of stacked matrices as the model expects.
    gt_boxes: (B, K, 9); gt_labels: (B, K) int32 (-1 padded).
    gt_semantic: (B, 1, H, W) int32 class-id masks.
    """
    rng = np.random.default_rng(seed)
    h, w = cfg.backbone.final_dim
    k = max_objs or cfg.head.max_objs

    imgs = rng.normal(0, 1, size=(batch, 1, 1, h, w, 3)).astype(np.float32)
    s2e_l, s2v_l, k_l, ida_l, ref_l = [], [], [], [], []
    for _ in range(batch):
        s2e, s2v, K, ida, ref_h = make_calibration(rng, (h, w))
        s2e_l.append(s2e)
        s2v_l.append(s2v)
        k_l.append(K)
        ida_l.append(ida)
        ref_l.append(ref_h)
    mats = {
        "sensor2ego_mats": np.stack(s2e_l)[:, None, None],
        "sensor2virtual_mats": np.stack(s2v_l)[:, None, None],
        "intrin_mats": np.stack(k_l)[:, None, None],
        "ida_mats": np.stack(ida_l)[:, None, None],
        "sensor2sensor_mats": np.tile(
            np.eye(4, dtype=np.float32), (batch, 1, 1, 1, 1)),
        "reference_heights": np.asarray(ref_l, np.float32)[:, None, None],
        "bda_mat": np.tile(np.eye(4, dtype=np.float32), (batch, 1, 1)),
    }

    gt_boxes = np.zeros((batch, k, 9), np.float32)
    gt_labels = np.full((batch, k), -1, np.int32)
    x0, x1 = cfg.head.point_cloud_range[0], cfg.head.point_cloud_range[3]
    y0, y1 = cfg.head.point_cloud_range[1], cfg.head.point_cloud_range[4]
    for b in range(batch):
        n = min(num_objs, k)
        gt_boxes[b, :n, 0] = rng.uniform(x0 + 5, x1 - 5, n)
        gt_boxes[b, :n, 1] = rng.uniform(y0 + 5, y1 - 5, n)
        gt_boxes[b, :n, 2] = rng.uniform(-1.0, 0.5, n)
        gt_boxes[b, :n, 3:6] = rng.uniform(0.5, 4.5, (n, 3))
        gt_boxes[b, :n, 6] = rng.uniform(-np.pi, np.pi, n)
        gt_labels[b, :n] = rng.integers(0, len(cfg.classes), n)
    gt_semantic = rng.integers(
        0, cfg.backbone.semantic_channels, size=(batch, 1, h, w)).astype(np.int32)
    return imgs, mats, gt_boxes, gt_labels, gt_semantic


LAYOUTS = ("rope3d-kitti", "dair-v2x-i", "rope3d")


def write_fake_kitti_root(root, n_frames: int = 6, src_hw=(216, 384),
                          seed: int = 0, learnable: bool = False,
                          static_scene: bool = False,
                          layout: str = "rope3d-kitti"):
    """Write a tiny on-disk rope3d-kitti-style dataset tree (images, masks,
    calib, label_eval GT, train/val info pkls) for integration tests and
    `chip_smoke.py`'s eval phase; the same seed writes the same files as
    the JAX package's. Returns the root path (str).

    `layout` writes the same frames in another dataset's own tree instead,
    as `runner.train`/`evaluate` and the evaluator's calibration readers
    find it from the root's name (which must then end in the layout's
    name): "dair-v2x-i", raw DAIR-V2X-I (`image/<id>.jpg`, the
    `calib/camera_intrinsic` and `calib/virtuallidar_to_camera` json files,
    `dair_12hz_infos_*.pkl` with `gen_info_dair`'s tokens, the GT in the
    sibling `dair-v2x-i-kitti/training/label_2`); "rope3d", raw Rope3D
    (`training-image_2a/<token>.jpg`, `training/calib` P2 and
    `training/denorm` files by token, `rope3d_12hz_infos_*.pkl`, the GT in
    `training/label_eval/<id>.txt`, the sibling
    `rope3d-kitti/map_token2id.json`), the camera as `gen_info_rope3d`
    reads it from its denorm. Neither has semantic masks (only SGV3D reads
    them). The random draws are the same in every layout.

    `static_scene` keeps the SAME object positions in every frame (a
    roadside rig watching parked cars): the easiest learnable scene — a toy
    detector can memorize it to nonzero KITTI AP in a few hundred steps,
    which is what a discriminating eval floor needs.

    Layout mirrors what `tools/converters` produce from the real datasets
    (the reference's scripts/data_converter/... output conventions).
    """
    import json
    import os
    import pickle

    from PIL import Image

    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: one of {LAYOUTS}")
    h_img, w_img = src_hw
    root = str(root)
    if layout != "rope3d-kitti" and not root.rstrip("/").endswith(layout):
        raise ValueError(f"a {layout} root's name ends in {layout!r}: {root}")
    parent = os.path.dirname(root.rstrip("/"))
    img_dir, calib_dir, gt_dir = {
        "rope3d-kitti": ("images", "training/calib", "training/label_eval"),
        "dair-v2x-i": ("image", "calib", os.path.join(
            parent, "dair-v2x-i-kitti", "training", "label_2")),
        "rope3d": ("training-image_2a", "training/calib", "training/label_eval"),
    }[layout]
    subs = [img_dir, calib_dir, gt_dir]
    if layout == "rope3d-kitti":
        subs.append("training/mask_image")
    elif layout == "dair-v2x-i":
        subs = [img_dir, gt_dir, "calib/camera_intrinsic",
                "calib/virtuallidar_to_camera"]
    else:
        subs.append("training/denorm")
    for sub in subs:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rng = np.random.default_rng(seed)
    infos = []
    cam_h = 6.0
    cam2ego_rot = (np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], float)
                   @ geom.rodrigues(np.array([0.15, 0, 0])).T)
    K = np.array([[400.0, 0, w_img / 2], [0, 400.0, h_img / 2], [0, 0, 1]])
    s2e = np.eye(4)
    s2e[:3, :3] = cam2ego_rot
    s2e[:3, 3] = [0, 0, cam_h]
    denorm = None
    if layout == "rope3d":
        # the camera gen_info_rope3d reads back from the ground plane
        from sgv3d_tpu_torch.evalkit.kitti_writer import get_cam2lidar_from_denorm

        denorm = geom.get_denorm(np.linalg.inv(s2e))
        s2e = get_cam2lidar_from_denorm(denorm)
        cam2ego_rot, cam_h = s2e[:3, :3], float(s2e[2, 3])
    velo2cam = np.linalg.inv(s2e)
    for i in range(n_frames):
        if learnable:
            # low-noise background so painted object blobs dominate: gives
            # the detector a learnable image->position signal (used by the
            # AP-delta quantification test)
            img = (rng.random((h_img, w_img, 3)) * 40).astype(np.uint8)
        else:
            img = (rng.random((h_img, w_img, 3)) * 255).astype(np.uint8)
        mask = (rng.integers(0, 4, (h_img, w_img, 3)) * 40).astype(np.uint8)
        name = f"frame_{i:06d}" if layout == "rope3d" else f"{i:06d}"
        if layout == "rope3d-kitti":
            np.save(os.path.join(root, "training/mask_image", f"{i:06d}.npy"),
                    mask)
        if layout == "dair-v2x-i":
            with open(os.path.join(root, "calib/camera_intrinsic",
                                   f"{name}.json"), "w") as f:
                json.dump({"cam_K": K.reshape(-1).tolist()}, f)
            with open(os.path.join(root, "calib/virtuallidar_to_camera",
                                   f"{name}.json"), "w") as f:
                json.dump({"rotation": velo2cam[:3, :3].tolist(),
                           "translation": velo2cam[:3, 3:].tolist()}, f)
        else:
            with open(os.path.join(root, calib_dir, f"{name}.txt"), "w") as f:
                f.write(f"P2: {K[0,0]} 0 {K[0,2]} 0 0 {K[1,1]} {K[1,2]} 0 "
                        "0 0 1 0\n")
                row = velo2cam[:3].reshape(-1)
                f.write("Tr_velo_to_cam: " + " ".join(f"{v}" for v in row) + "\n")
        if denorm is not None:
            with open(os.path.join(root, "training/denorm", f"{name}.txt"),
                      "w") as f:
                f.write(" ".join(f"{v}" for v in denorm) + "\n")
        gt_lines = []
        anns = []
        if static_scene and i == 0:
            static_xy = [(rng.uniform(6, 20), rng.uniform(-8, 8))
                         for _ in range(3)]
        for obj in range(3):
            if static_scene:
                x, y = static_xy[obj]
            else:
                x, y = rng.uniform(6, 20), rng.uniform(-8, 8)
            anns.append(dict(
                category_name="vehicle.car",
                translation=[x, y, 0.8],
                size=[1.9, 4.5, 1.6], rotation=[1.0, 0, 0, 0],
                velocity=[0, 0, 0], num_lidar_pts=5, num_radar_pts=0))
            cam = velo2cam @ np.array([x, y, 0.0, 1.0])
            if learnable:
                uvw = K @ cam[:3]
                u, v = uvw[0] / uvw[2], uvw[1] / uvw[2]
                if 0 <= u < w_img and 0 <= v < h_img:
                    yy, xx = np.mgrid[0:h_img, 0:w_img]
                    blob = ((xx - u) ** 2 + (yy - v) ** 2) < (
                        max(4.0, 120.0 / cam[2]) ** 2)
                    img[blob] = 255
            # dims columns are (h, l, w) — the reference converters' i9/i11/
            # i10 swap (the reference's scripts/data_converter/gen_kitti/
            # label_json2kitti.py:19), the convention every label file in
            # this pipeline uses (writer AND GT; tools/converters/dair.py:92)
            gt_lines.append(
                f"Car 0 0 0.5 100 100 200 200 1.6 4.5 1.9 "
                f"{cam[0]:.4f} {cam[1]:.4f} {cam[2]:.4f} {np.pi/2:.4f}")
        filename = f"{img_dir}/{name}.jpg"
        Image.fromarray(img).save(os.path.join(root, filename))
        with open(os.path.join(root, gt_dir, f"{i:06d}.txt"), "w") as f:
            f.write("\n".join(gt_lines) + "\n")
        infos.append(dict(
            sample_token={"rope3d-kitti": f"{i:06d}", "dair-v2x-i": filename,
                          "rope3d": name}[layout], scene_token="s0",
            cam_infos={"CAM_FRONT": dict(
                filename=filename,
                calibrated_sensor=dict(
                    rotation_matrix=cam2ego_rot.tolist(),
                    translation=[0.0, 0.0, cam_h],
                    camera_intrinsic=K.tolist()),
                ego_pose=dict(rotation=[1.0, 0, 0, 0],
                              translation=[0.0, 0.0, 0.0]),
                timestamp=0)},
            sweeps=[], ann_infos=anns))
    names = {"rope3d-kitti": ("rope3d_12hz_infos_train_dair.pkl",
                              "rope3d_12hz_infos_val_dair.pkl"),
             "dair-v2x-i": ("dair_12hz_infos_train.pkl", "dair_12hz_infos_val.pkl"),
             "rope3d": ("rope3d_12hz_infos_train.pkl", "rope3d_12hz_infos_val.pkl")}
    for name in names[layout]:
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump(infos, f)
    if layout == "rope3d":
        kitti = os.path.join(parent, "rope3d-kitti")
        os.makedirs(kitti, exist_ok=True)
        with open(os.path.join(kitti, "map_token2id.json"), "w") as f:
            json.dump({info["sample_token"]: i for i, info in enumerate(infos)}, f)
    return root
