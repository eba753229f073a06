"""The H5 pose-pair path of the port (models/pose_data.py, io/h5_dataset.py,
ops/warp.py::warp_perspective and io/png.py's in-memory PNGs) against the
JAX package on the CPU.

Tolerances:
- warp_perspective: bit-equal where the transform's inverse is exact
  (power-of-two scales, offsets on a 1/8 grid: every coordinate and tap
  weight is exact in float32), except the bilinear sum of fractional taps:
  within 2.4e-7 there (2 ulps of values below 1; XLA contracts the taps'
  products and sums into fused multiply-adds); on a general homography the bilinear
  output within 1e-5, and nearest picks equal on at least 99.5% of the
  pixels (a coordinate within an ulp of a half-pixel can round either way
  when the two inverses differ by an ulp) and on all but 0.1% of them in
  the crop of a render (tests/test_rasterize.py's raster-convention case);
- PNG blobs: decoded equal to imageio's, both ways;
- H5 files: every array and scalar equal across the two packages' writers
  and readers;
- transform_batch: within 1e-6 (the same float32 operations; the xyz
  lift divides by fx, fy in both)."""
import io
import os

import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sixdof_tpu.io import h5_dataset as jh5
from sixdof_tpu.models.pose_data import PoseData as JPoseData
from sixdof_tpu.ops import warp as jwarp
from sixdof_tpu_torch.io import h5_dataset as th5
from sixdof_tpu_torch.io.png import decode_png, encode_png
from sixdof_tpu_torch.models.pose_data import BatchPoseData, PoseData
from sixdof_tpu_torch.ops.warp import warp_perspective

h5py = pytest.importorskip("h5py")

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def _warp_both(img, tfs, out_hw, mode):
    j = np.asarray(jwarp.warp_perspective(jnp.asarray(img), jnp.asarray(tfs), out_hw, mode=mode))
    t = warp_perspective(torch.tensor(img), torch.tensor(tfs), out_hw, mode=mode).numpy()
    return t, j


EXACT = {  # power-of-two scales, offsets on a 1/8 grid
    "identity": [np.eye(3)],
    "scale_2": [np.diag([2.0, 2.0, 1.0])],
    "crops": [[[2.0, 0, -8], [0, 2.0, -4], [0, 0, 1]], [[0.5, 0, 3], [0, 0.25, 1.5], [0, 0, 1]],
              [[4.0, 0, -0.5], [0, 0.5, 2.125], [0, 0, 1]]],
}


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("case", list(EXACT))
def test_warp_perspective_bit_equal_on_exact_transforms(case, mode):
    """tests/test_rasterize.py's identity and 2x scale, and crops with
    power-of-two scales, on a colour image and a 2-D one."""
    rng = np.random.RandomState(3)
    tfs = np.asarray(EXACT[case], np.float32)
    for img in (rng.rand(40, 50, 3).astype(np.float32), rng.rand(20, 30).astype(np.float32)):
        t, j = _warp_both(img, tfs, (32, 36), mode)
        assert t.shape == j.shape
        if mode == "bilinear" and case == "crops":  # fractional taps
            np.testing.assert_allclose(t, j, rtol=0, atol=2.4e-7)
        else:
            np.testing.assert_array_equal(t, j)
    img = np.zeros((20, 30, 3), np.float32)
    img[5, 7] = [1.0, 2.0, 3.0]
    t, _ = _warp_both(img, np.diag([2.0, 2.0, 1.0]).astype(np.float32)[None], (40, 60), mode)
    np.testing.assert_array_equal(t[0, 10, 14], [1, 2, 3])  # src (7,5) -> dst (14,10)


def test_warp_perspective_general_homography():
    """tests/test_rasterize.py's non-power-of-two crop and a projective
    homography."""
    rng = np.random.RandomState(3)
    img = rng.rand(40, 50, 3).astype(np.float32)
    tfs = np.array([[[0.5, 0, 3], [0, 0.8, 1], [0, 0, 1]],
                    [[0.9, 0.1, 2.3], [-0.05, 1.1, -1.7], [1e-3, -2e-3, 1.0]]], np.float32)
    t, j = _warp_both(img, tfs, (32, 32), "bilinear")
    np.testing.assert_allclose(t, j, atol=1e-5)
    t, j = _warp_both(img, tfs, (32, 32), "nearest")
    assert (t == j).all(axis=-1).mean() >= 0.995


def test_warp_perspective_of_a_render():
    """The depth of a full-frame render warped into a crop window with
    nearest sampling (tests/test_rasterize.py::test_warp_matches_raster_convention)."""
    from sixdof_tpu.io.mesh_io import TriMesh
    from sixdof_tpu.ops import rasterize as ras
    from sixdof_tpu.ops.geometry import compute_crop_window_tf_batch

    v = np.array([[-0.04, -0.03, -0.02], [0.04, -0.03, -0.02], [0.04, 0.03, -0.02],
                  [-0.04, 0.03, -0.02], [-0.04, -0.03, 0.02], [0.04, -0.03, 0.02],
                  [0.04, 0.03, 0.02], [-0.04, 0.03, 0.02]])
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                  [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]])
    K = np.array([[200.0, 0, 120], [0, 200.0, 90], [0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.02, 0.01, 0.45]
    crop = np.asarray(compute_crop_window_tf_batch(jnp.asarray(pose[None]), jnp.asarray(K),
                                                   crop_ratio=1.2, out_size=(64, 64),
                                                   mesh_diameter=0.15))
    full = np.asarray(ras.render_batch(ras.make_mesh_arrays(TriMesh(v, f)),
                                       jnp.asarray(pose[None]), K, None,
                                       out_hw=(180, 240))["depth"][0])
    t, j = _warp_both(full, crop, (64, 64), "nearest")
    assert (t > 0).sum() > 500
    assert (t != j).mean() <= 1e-3


@pytest.mark.parametrize("shape,dtype", [((9, 7, 3), np.uint8), ((9, 7), np.uint16),
                                         ((9, 7), np.uint8), ((9, 7, 4), np.uint8),
                                         ((9, 7, 2), np.uint8)])
def test_png_blobs_decode_like_imageio(shape, dtype):
    """The port's PNG bytes read by imageio, and imageio's read by the port:
    RGB order for colour, uint16 for 16-bit grey."""
    img = np.random.RandomState(1).randint(0, np.iinfo(dtype).max, shape).astype(dtype)
    blob = encode_png(img)
    np.testing.assert_array_equal(imageio.imread(io.BytesIO(blob)), img)
    buf = io.BytesIO()
    imageio.imwrite(buf, img, format="png")
    got = decode_png(buf.getvalue())
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(th5._decode_image(np.void(blob)), img)


# ------------------------------------------------------------------- files --


def _samples(rng, cls, H=32, W=32, z=0.8, diameter=0.05):
    """Samples with a non-identity crop (scale 0.5 into a 64x64 frame),
    depth steps (some |c| >= 2 after normalisation) and an invalid strip."""
    def one():
        depth = np.full((H, W), z, np.float32) + rng.uniform(-0.06, 0.06, (H, W))
        depth[:4] = 0.0
        poseA = np.eye(4, dtype=np.float32)
        poseA[:3, 3] = [0.01, -0.005, z]
        K = np.array([[60.0, 0, 32.5], [0, 60.0, 31.5], [0, 0, 1]], np.float32)
        tf = np.array([[0.5, 0, 0.25], [0, 0.5, -0.5], [0, 0, 1]], np.float32)
        return cls(rgbA=rng.integers(0, 255, (H, W, 3), dtype=np.uint8),
                   rgbB=rng.integers(0, 255, (H, W, 3), dtype=np.uint8), depthA=depth,
                   depthB=np.roll(depth, 3, axis=1), poseA=poseA, poseB=poseA.copy(), K=K,
                   tf_to_crop=tf, mesh_diameter=diameter, target=0.01)

    return {f"ob_{i}": [one(), one()] for i in range(3)}


FIELDS = ("rgbA", "rgbB", "depthA", "depthB", "poseA", "poseB", "K", "tf_to_crop",
          "mesh_diameter", "target")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_h5_files_cross_read(tmp_path, writer):
    """A file written by one package's write_pair_h5 (with the _keys.pkl
    sidecar) read by both readers: the same keys, metadata and samples."""
    rng = np.random.default_rng(0)
    path = str(tmp_path / "pairs.h5")
    if writer == "port":
        th5.write_pair_h5(path, _samples(rng, PoseData), crop_ratio=1.4, H_ori=64, W_ori=64,
                          write_keys_pkl=True)
    else:
        jh5.write_pair_h5(path, _samples(rng, JPoseData), crop_ratio=1.4, H_ori=64, W_ori=64,
                          write_keys_pkl=True)
    j, t = jh5.PairH5Dataset(h5_file=path), th5.PairH5Dataset(h5_file=path)
    for k in ("object_keys", "n_perturb", "H_ori", "W_ori", "trans_normalizer",
              "rot_normalizer", "cfg"):
        assert getattr(t, k) == getattr(j, k), k
    assert t.object_keys == ["ob_0", "ob_1", "ob_2"] and (t.H_ori, t.W_ori) == (64, 64)
    assert t.rot_normalizer == pytest.approx(np.deg2rad(20.0))
    assert len(th5.PairH5Dataset(h5_file=path, max_num_key=2)) == 2
    for key in t.object_keys:
        for i in range(2):
            a, b = t.load_sample(key, i), j.load_sample(key, i)
            for f in FIELDS:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
            assert a.rgbA.dtype == np.uint8 and a.depthA.dtype == np.float32
    os.rename(path.replace(".h5", "_keys.pkl"), str(tmp_path / "aside.pkl"))
    assert sorted(th5.PairH5Dataset(h5_file=path).object_keys) == ["ob_0", "ob_1", "ob_2"]
    # the reference's defaults where the file has no H_ori/W_ori
    with h5py.File(path, "a") as hf:
        for key in hf:
            for sub in hf[key].values():
                del sub["H_ori"], sub["W_ori"]
    t = th5.PairH5Dataset(h5_file=path)
    assert (t.H_ori, t.W_ori) == (540, 720) == (jh5.PairH5Dataset(h5_file=path).H_ori, 720)


@pytest.mark.parametrize("cls", ["PairH5Dataset", "TripletH5Dataset", "ScoreMultiPairH5Dataset",
                                 "PoseRefinePairH5Dataset"])
def test_transform_batch_matches_jax(tmp_path, cls):
    """load_batch + transform_batch of both packages on the same file: rgb
    / 255, the depth unwarped to (H_ori, W_ori), lifted, re-warped,
    recentred at poseA and divided by the radius, with the class's
    invalid-z threshold and the per-channel |c| >= 2 zeroing."""
    path = str(tmp_path / "pairs.h5")
    th5.write_pair_h5(path, _samples(np.random.default_rng(1), PoseData), H_ori=64, W_ori=64)
    j, t = getattr(jh5, cls)(h5_file=path), getattr(th5, cls)(h5_file=path)
    assert t._INVALID_Z == j._INVALID_Z
    jb = j.transform_batch(j.load_batch(j.object_keys, 1), j.H_ori, j.W_ori)
    tb = t.transform_batch(t.load_batch(t.object_keys, 1), t.H_ori, t.W_ori)
    for k in ("rgbAs", "rgbBs", "xyz_mapAs", "xyz_mapBs"):
        got, want = getattr(tb, k), np.asarray(getattr(jb, k))
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, err_msg=k)
    xyz = tb.xyz_mapBs.numpy()
    assert (xyz[:, :4] == 0).all()  # the invalid strip
    # the |c| >= 2 zeroing hit some channels only: pixels with a zero and a
    # non-zero channel
    assert ((xyz == 0).any(-1) & (xyz != 0).any(-1)).any()


def test_select_by_indices_device_n_view_and_train_num_pair(tmp_path):
    path = str(tmp_path / "pairs.h5")
    th5.write_pair_h5(path, _samples(np.random.default_rng(2), PoseData))
    t = th5.PairH5Dataset(h5_file=path)
    batch = t.load_batch(t.object_keys)
    sub = batch.select_by_indices(np.array([2, 0]))
    np.testing.assert_array_equal(sub.rgbAs[0], batch.rgbAs[2])
    np.testing.assert_array_equal(sub.poseA[1], batch.poseA[0])
    on = batch.device("cpu")
    assert isinstance(on.rgbAs, torch.Tensor) and on.mesh_diameters.dtype == torch.float32
    sub = on.select_by_indices([1])
    assert torch.equal(sub.rgbBs[0], on.rgbBs[1]) and sub.Ks.shape == (1, 3, 3)
    ref = th5.PoseRefinePairH5Dataset(cfg={"n_view": 4}, h5_file=path)
    jref = jh5.PoseRefinePairH5Dataset(cfg={"n_view": 4}, h5_file=path)
    assert ref.cfg["n_view"] == jref.cfg["n_view"] == 1  # depthA strip == depthB width
    sc = th5.ScoreMultiPairH5Dataset(h5_file=path)
    assert sc.cfg["train_num_pair"] == jh5.ScoreMultiPairH5Dataset(h5_file=path).cfg[
        "train_num_pair"] == 2
    assert len(th5.PairH5Dataset(mode="test")) == 1
    assert isinstance(BatchPoseData().select_by_indices([0]), BatchPoseData)
