"""The port's host data feed against the JAX package's, on the CPU.

Every input is written by the test from a seed: a GPS trace CSV with a gap,
camera and map PNGs (by PIL, whose writer picks a filter a row, and by the
port's own encoder), calibration PNGs with gray pixels. The processor,
PNG decode, native calls, cache, augmenter, dataset samples, loader
batches, map tiles and gray mask must equal the JAX package's bit for bit;
the device-side ``preprocess_batch`` (XLA's resize there, plain PyTorch
here) within PREPROCESS_TOL. The JAX dataset is given
``native_min_pixels=0`` so that it takes its native path at every frame
size, as the port always does.
"""

import random
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from bevrender_tpu.data import dataset as jds
from bevrender_tpu.data import maploader as jml
from bevrender_tpu.data import native as jnative
from bevrender_tpu.data import prefetch as jprefetch
from bevrender_tpu.data import preprocess as jpre
from bevrender_tpu.data import processor as jproc
from bevrender_tpu.geometry import projection as jproj
from bevrender_tpu_torch.data import dataset as tds
from bevrender_tpu_torch.data import maploader as tml
from bevrender_tpu_torch.data import native as tnative
from bevrender_tpu_torch.data import png as tpng
from bevrender_tpu_torch.data import prefetch as tprefetch
from bevrender_tpu_torch.data import preprocess as tpre
from bevrender_tpu_torch.data import processor as tproc
from bevrender_tpu_torch.geometry import projection as tproj

# float32 sums in another order (a contraction per axis here, one einsum
# there) on values up to 255 / 0.225: measured <= 3.5e-6
PREPROCESS_TOL = 1e-5
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
JGW = (1.0, 0.0, 0.0, -1.0, 0.0, 1000.0)


def _write_trace(root, n=24, gap_at=13, views=3, vh=20, vw=24, tile=20,
                 seed=0):
    """A CSV trace at 4 Hz with a 5 s gap before frame ``gap_at``, a wide
    camera PNG and a map tile PNG a frame, written by PIL."""
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    (root / "map").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    rows, ts = [], 1_700_000_000_000_000
    for i in range(n):
        if i == gap_at:
            ts += 5_000_000
        rows.append([ts, 0, 500.0 + 3 * i, 400.0 + 2 * i, -10.0, 0.0, 0.0,
                     0.1 * i])
        wide = rng.integers(0, 256, (vh, views * vw, 3), dtype=np.uint8)
        Image.fromarray(wide).save(root / "rgb" / f"{ts}.png")
        Image.fromarray(rng.integers(0, 256, (tile, tile, 3), np.uint8)).save(
            root / "map" / f"{ts}.png")
        ts += 250_000
    np.savetxt(root / "gps.csv", np.asarray(rows, np.float64), delimiter=",")
    return root


@pytest.fixture(scope="module")
def trace(tmp_path_factory):
    return _write_trace(tmp_path_factory.mktemp("trace"))


def _processors(root, **kw):
    args = dict(gps_file_path=str(root / "gps.csv"),
                rgb_img_dir=str(root / "rgb"), map_img_dir=str(root / "map"),
                jgw_info=JGW, map_width=1200, map_height=1200,
                window_timespin=1_000_000.0, window_num_imgs=2)
    args.update(kw)
    return jproc.DatasetProcessor(**args), tproc.DatasetProcessor(**args)


def _ts(windows):
    return [[r[jproc.REC_TIMESTAMP] for r in w] for w in windows]


# ---------------------------------------------------------------- processor

def test_processor_constants_and_affine_equal():
    names = [n for n in dir(jproc) if n.startswith("REC_") or n.endswith("_COL")]
    assert names and all(getattr(jproc, n) == getattr(tproc, n) for n in names)
    assert tproc.SPLIT_TIMESPIN_US == jproc.SPLIT_TIMESPIN_US
    jgw = (0.8, 0.6, -0.6, 0.8, 100.0, 200.0)
    for n, e in ((400.0, 500.0), (1234.5, -17.25)):
        assert tproc.pixel_from_utm(n, e, jgw) == jproc.pixel_from_utm(n, e, jgw)


@pytest.mark.parametrize("overlap", [False, True])
def test_processor_records_windows_and_split_equal(trace, overlap):
    jp, tp = _processors(trace, overlap=overlap)
    jrec, trec = jp.get_full_datalist(), tp.get_full_datalist()
    assert trec == jrec and len(trec) == 24
    jseq, tseq = jp.split_sequence(jrec), tp.split_sequence(trec)
    assert [len(s) for s in tseq] == [len(s) for s in jseq] == [13, 11]
    assert tp.process_windows() == jp.process_windows()
    assert _ts(tp.get_train_datalist(tseq)) == _ts(jp.get_train_datalist(jseq))
    assert (_ts(tp.get_overlap_train_datalist(tseq))
            == _ts(jp.get_overlap_train_datalist(jseq)))
    jval, jrest = jp.get_val_datalist(jseq, 0.3, random.Random(5))
    tval, trest = tp.get_val_datalist(tseq, 0.3, random.Random(5))
    assert _ts(tval) == _ts(jval) and tval
    assert _ts(trest) == _ts(jrest)


# ---------------------------------------------------------------- PNG

def _modes(arr):
    """(name, PIL image) of every mode the decoder takes."""
    img = Image.fromarray(arr)
    return [("RGB", img), ("RGBA", img.convert("RGBA")), ("L", img.convert("L")),
            ("LA", img.convert("LA")), ("P", img.convert("P")),
            ("P4", img.convert("P", palette=Image.ADAPTIVE, colors=16)),
            ("P1", img.convert("P", palette=Image.ADAPTIVE, colors=2)),
            ("1", img.convert("1"))]


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "P4", "P1",
                                  "1"])
def test_png_decode_equals_jax(tmp_path, mode):
    """8-bit RGB, RGBA, gray, gray+alpha and palette files, and 1- and
    4-bit palette and 1-bit gray, bit for bit as the JAX package's decode
    (libpng) and PIL's convert("RGB") read them; the header probe too."""
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    path = tmp_path / f"{mode}.png"
    dict(_modes(arr))[mode].save(path)
    out = tnative.decode_png(str(path))
    np.testing.assert_array_equal(out, jds._decode_rgb(str(path)))
    np.testing.assert_array_equal(
        out, np.asarray(Image.open(path).convert("RGB")))
    assert tnative.probe_png(str(path)) == jnative.probe_png(str(path))


def test_png_alpha_dropped(tmp_path):
    """Alpha below 255 is dropped, as PIL's convert("RGB") drops it."""
    rng = np.random.default_rng(2)
    rgba = rng.integers(0, 256, (19, 23, 4), dtype=np.uint8)
    path = tmp_path / "a.png"
    Image.fromarray(rgba, "RGBA").save(path)
    np.testing.assert_array_equal(tnative.decode_png(str(path)), rgba[..., :3])


def _interlaced_copy(src, dst):
    """``src`` with the interlace byte of its IHDR set (CRC fixed)."""
    raw = bytearray(src.read_bytes())
    raw[28] = 1
    raw[29:33] = struct.pack(">I", zlib.crc32(bytes(raw[12:29])) & 0xFFFFFFFF)
    dst.write_bytes(bytes(raw))


def test_png_unsupported_formats_raise(tmp_path):
    rng = np.random.default_rng(3)
    deep = tmp_path / "deep.png"
    Image.fromarray(rng.integers(0, 65535, (8, 9), dtype=np.uint16)).save(deep)
    rgb = tmp_path / "rgb.png"
    tpng.encode_png(rgb, rng.integers(0, 256, (8, 9, 3), dtype=np.uint8))
    laced = tmp_path / "laced.png"
    _interlaced_copy(rgb, laced)
    jpg = tmp_path / "x.jpg"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(jpg)
    for path, what in ((deep, "16-bit gray"), (laced, "Adam7 interlaced"),
                       (jpg, "not a PNG")):
        for fn in (tnative.decode_png,
                   lambda p: tnative.decode_png_resize_u8(p, 4, 4),
                   lambda p: tnative.decode_png_views(p, 1, 4, 4, MEAN, STD)):
            with pytest.raises(ValueError, match=what) as e:
                fn(str(path))
            assert str(path) in str(e.value)


@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_png_encoder_round_trip(tmp_path, kind):
    """The port's encoder: PIL and the JAX package's decode read back the
    array, and so does the port's."""
    rng = np.random.default_rng(4)
    if kind == "noise":
        arr = rng.integers(0, 256, (41, 67, 3), dtype=np.uint8)
    else:
        arr = (np.cumsum(rng.integers(0, 4, (41, 67, 3)), axis=1) % 256
               ).astype(np.uint8)
    path = tmp_path / "e.png"
    tpng.encode_png(path, arr)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    np.testing.assert_array_equal(jds._decode_rgb(str(path)), arr)
    np.testing.assert_array_equal(tnative.decode_png(str(path)), arr)
    with pytest.raises(ValueError):
        tpng.encode_png(path, arr.astype(np.float32))


# ---------------------------------------------------------------- native

@pytest.mark.parametrize("src,out", [((48, 96), (24, 48)), ((30, 45), (61, 90)),
                                     ((40, 60), (20, 120)), ((33, 66), (33, 66))])
def test_native_calls_equal_jax(tmp_path, src, out):
    """Shrink, grow, one axis each way, identity: every entry point bit for
    bit as the JAX package's native library."""
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 256, (*src, 3), dtype=np.uint8)
    path = str(tmp_path / "f.png")
    Image.fromarray(arr).save(path)
    h, w = out
    v = 3 if w % 3 == 0 else 2
    eq = np.testing.assert_array_equal
    eq(tnative.resize_u8(arr, h, w), jnative.resize_u8(arr, h, w))
    eq(tnative.fused_views(arr, v, h, w, MEAN, STD),
       jnative.fused_views(arr, v, h, w, MEAN, STD))
    eq(tnative.to_unit_f32(arr), jnative.to_unit_f32(arr))
    eq(tnative.decode_png_views(path, v, h, w, MEAN, STD),
       jnative.decode_png_views(path, v, h, w, MEAN, STD))
    eq(tnative.decode_png_resize_u8(path, h, w),
       jnative.decode_png_resize_u8(path, h, w))
    parts = [arr, arr[::-1].copy(), np.ascontiguousarray(arr[:, ::-1])]
    eq(tnative.stack(parts), jnative.stack(parts))
    eq(tnative.stack(parts), np.stack(parts))


def test_native_views_guard(tmp_path):
    """A width that does not split into the views raises in Python, and
    the library's own entry refuses it too (no write past the output)."""
    arr = np.zeros((8, 10, 3), np.uint8)
    path = tmp_path / "g.png"
    tpng.encode_png(path, arr)
    with pytest.raises(ValueError, match="not divisible"):
        tnative.decode_png_views(str(path), 3, 8, 10, MEAN, STD)
    with pytest.raises(ValueError, match="not divisible"):
        tnative.fused_views(arr, 3, 8, 10, MEAN, STD)
    img = tpng.read(path)
    h = img.header
    dst = np.zeros((3, 8, 4, 3), np.float32)
    mean = np.asarray(MEAN, np.float32)
    std = np.asarray(STD, np.float32)
    rc = tnative.load().bev_png_views(
        img.data, len(img.data), h.height, h.width, h.color_type, h.depth,
        None, 0, dst.ctypes.data, 3, 8, 10, mean.ctypes.data, std.ctypes.data)
    assert rc == 5 and not dst.any()


# ---------------------------------------------------------------- cache

def test_byte_lru_evicts_by_bytes_and_freezes_frames():
    cache = tds._ByteLRU(max_bytes=300)
    a, b, c = (np.full(100, i, np.uint8) for i in range(3))
    for k, v in (("a", a), ("b", b), ("c", c)):
        cache.put(k, v)
    assert cache.get("a") is a and cache.hits == 1
    cache.put("d", np.zeros(100, np.uint8))  # evicts b, the least recent
    assert cache.get("b") is None and cache.misses == 1
    assert cache.get("c") is c and cache.get("d") is not None
    cache.put("big", np.zeros(301, np.uint8))  # over the cap: not kept
    assert cache.get("big") is None and cache.misses == 2
    assert not a.flags.writeable
    with pytest.raises(ValueError):
        cache.get("a")[0] = 9
    # the JAX package's LRU with the same calls: the same hits and misses
    ref = jds._ByteLRU(max_bytes=300)
    for k, v in (("a", a), ("b", b), ("c", c)):
        ref.put(k, v.copy())
    ref.get("a")
    ref.put("d", np.zeros(100, np.uint8))
    assert ref.get("b") is None and ref.get("c") is not None


@pytest.mark.parametrize("kind", ["none", "weak", "strong"])
def test_augmenter_equals_jax(kind):
    rng = np.random.default_rng(6)
    jr, tr = random.Random(9), random.Random(9)
    ja, ta = jds.Augmenter(kind, jr), tds.Augmenter(kind, tr)
    for _ in range(12):
        img = rng.integers(0, 256, (10, 14, 3), dtype=np.uint8)
        np.testing.assert_array_equal(ta(img), ja(img))
    assert tr.getstate() == jr.getstate()
    with pytest.raises(RuntimeError):
        tds.Augmenter("medium", tr)


# ---------------------------------------------------------------- dataset

def _datasets(root, **kw):
    jp, tp = _processors(root, overlap=True)
    windows = tp.process_windows()
    args = dict(num_views=3, window_num_imgs=2, resize_img_height=16,
                resize_img_width=36, seed=11)
    args.update(kw)
    return (jds.GPSDeniedDataset(jp.process_windows(), native_min_pixels=0,
                                 **args),
            tds.GPSDeniedDataset(windows, **args))


def _assert_sample_equal(t, j):
    assert t.keys() == j.keys()
    for k in t:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


@pytest.mark.parametrize("aug,cache_mb,raw,mode", [
    ("none", 0, False, "train"), ("none", 64, False, "train"),
    ("weak", 64, False, "train"), ("strong", 0, False, "train"),
    ("strong", 64, True, "train"), ("none", 64, True, "train"),
    ("none", 64, False, "inference"), ("weak", 0, True, "inference"),
])
def test_dataset_samples_equal_jax(trace, aug, cache_mb, raw, mode):
    """Every sample of the trace, read twice (the second pass hits the
    cache), bit for bit as the JAX package's."""
    jd, td = _datasets(trace, data_augmentation=aug, cache_mb=cache_mb,
                       raw_uint8=raw, mode=mode)
    assert len(td) == len(jd) > 4
    for _ in range(2):
        for i in range(len(td)):
            _assert_sample_equal(td[i], jd[i])
    if cache_mb:
        assert td.cache.hits == jd.cache.hits > 0
    s = td[0]
    assert s["camera"].shape[1:] == ((20, 72, 3) if raw else (3, 16, 12, 3))


def test_dataset_without_resize_equals_jax(trace):
    jd, td = _datasets(trace, resize_cmr_img=False, resize_img_height=20,
                       resize_img_width=72)
    for i in range(3):
        _assert_sample_equal(td[i], jd[i])


def test_loader_batches_equal_jax(trace):
    """The port's DataLoader over the port's dataset gives the batches of
    the JAX package's loader over its own, shuffled, two epochs."""
    jd, td = _datasets(trace, cache_mb=64)
    jl = jprefetch.DataLoader(jd, 2, shuffle=True, num_workers=1, seed=3)
    tl = tprefetch.DataLoader(td, 2, shuffle=True, num_workers=1, seed=3)
    for epoch in range(2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb) == len(td) // 2
        for t, j in zip(tb, jb):
            _assert_sample_equal(t, j)


@pytest.mark.parametrize("raw", [False, True])
def test_synthetic_geo_dataset_equal(raw):
    args = dict(n_items=6, num_views=2, window_num_imgs=2, img_height=16,
                img_width=16, map_tile=16, world=96, seed=4, raw_uint8=raw,
                detail=0.5)
    jd, td = jds.SyntheticGeoDataset(**args), tds.SyntheticGeoDataset(**args)
    np.testing.assert_array_equal(td.world_img, jd.world_img)
    for i in range(len(td)):
        _assert_sample_equal(td[i], jd[i])
    with pytest.raises(ValueError, match="too small"):
        tds.SyntheticGeoDataset(world=40, img_height=16, map_tile=16)


@pytest.mark.parametrize("normalize", [True, False])
def test_map_tiles_equal_jax(tmp_path, normalize):
    rng = np.random.default_rng(8)
    world = rng.integers(0, 256, (70, 90, 3), dtype=np.uint8)
    path = tmp_path / "map.png"
    Image.fromarray(world).save(path)
    jl = jml.MapLoader({"june": str(path)}, "june")
    tl = tml.MapLoader({"june": str(path)}, "june")
    np.testing.assert_array_equal(tl.get_map_array(normalize),
                                  jl.get_map_array(normalize))
    np.testing.assert_array_equal(tl.get_map_img(), np.asarray(jl.get_map_img()))
    for stride in (None, 13):
        jt = list(jl.iter_tiles(32, stride=stride, normalize=normalize))
        tt = list(tl.iter_tiles(32, stride=stride, normalize=normalize))
        assert [p for p, _ in tt] == [p for p, _ in jt] and tt
        for (_, a), (_, b) in zip(tt, jt):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- device stage

@pytest.mark.parametrize("src,out", [((64, 240), (28, 84)),  # shrink
                                     ((30, 60), (75, 150)),  # grow
                                     ((32, 96), (32, 96)),  # identity
                                     ((40, 60), (20, 120)),  # mixed
                                     ((20, 90), (50, 30))])  # mixed
def test_preprocess_batch_equals_jax(src, out):
    rng = np.random.default_rng(9)
    cam = rng.integers(0, 256, (2, 2, *src, 3), dtype=np.uint8)
    mp = rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    kw = dict(num_views=3, resize_h=out[0], resize_w=out[1], cam_mean=MEAN,
              cam_std=STD)
    j = jpre.preprocess_batch(jnp.asarray(cam), jnp.asarray(mp), **kw)
    t = tpre.preprocess_batch(torch.from_numpy(cam), torch.from_numpy(mp), **kw)
    assert tuple(t["camera"].shape) == j["camera"].shape
    assert t["camera"].dtype == torch.float32
    np.testing.assert_allclose(t["camera"].numpy(), np.asarray(j["camera"]),
                               rtol=0, atol=PREPROCESS_TOL)
    np.testing.assert_array_equal(t["map"].numpy(), np.asarray(j["map"]))
    # k stacked batches (steps_per_dispatch): the stage maps over k
    k = tpre.preprocess_batch(torch.from_numpy(np.stack([cam, cam[::-1]])),
                              torch.from_numpy(np.stack([mp, mp])), **kw)
    assert torch.equal(k["camera"][0], t["camera"])
    assert torch.equal(k["camera"][1], t["camera"].flip(0))


def test_preprocess_weights_equal_jax():
    from jax._src.image import scale as jscale

    for m, n in ((1920, 672), (512, 224), (30, 75), (7, 7)):
        ref = jscale.compute_weight_mat(
            m, n, n / m, 0.0, lambda x: jnp.maximum(0, 1 - jnp.abs(x)), True)
        # weights <= 1, summed and divided in another order: one ulp at 1
        np.testing.assert_allclose(tpre.resize_weights(m, n).numpy(),
                                   np.asarray(ref), rtol=0, atol=2.0 ** -23)


def test_preprocessors_and_prefetch(trace):
    """The stage ``on_device_preprocess`` selects, applied by
    ``device_prefetch`` after the copy; the cast stage equals JAX's."""
    from bevrender_tpu_torch.config import DataConfig

    assert tpre.make_preprocessor(DataConfig()) is None
    dc = DataConfig(num_views=3, resize_img_height=16, resize_img_width=36,
                    on_device_preprocess=True)
    _, td = _datasets(trace, raw_uint8=True, cache_mb=64)
    raws = list(tprefetch.DataLoader(td, 2, num_workers=1))
    stage = tpre.make_preprocessor(dc)
    for raw, out in zip(raws, tprefetch.device_prefetch(
            iter(raws), "cpu", preprocess=stage)):
        ref = stage({k: torch.from_numpy(v) for k, v in raw.items()})
        assert out["camera"].shape == (2, 3, 3, 16, 12, 3)
        for key in ref:
            assert torch.equal(out[key], ref[key]), key
    cast = tpre.make_preprocessor(DataConfig(on_device_preprocess="cast"))
    rng = np.random.default_rng(10)
    cam = rng.integers(0, 256, (2, 2, 2, 8, 8, 3), dtype=np.uint8)
    mp = rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    got = cast({"camera": torch.from_numpy(cam), "map": torch.from_numpy(mp),
                "vehicle_type": torch.zeros(2, 1)})
    ref = jpre.make_cast_preprocessor()({"camera": jnp.asarray(cam),
                                         "map": jnp.asarray(mp)})
    np.testing.assert_array_equal(got["camera"].numpy(),
                                  np.asarray(ref["camera"]))
    np.testing.assert_array_equal(got["map"].numpy(), np.asarray(ref["map"]))
    assert "vehicle_type" in got


# ---------------------------------------------------------------- gray mask

def test_gray_mask_reference_points_equal_jax(tmp_path):
    """Reference points with ``remove_ref_in_gray`` on calibration PNGs
    whose gray blocks cover part of each view: equal to the JAX package's,
    and fewer than without the mask."""
    rng = np.random.default_rng(12)
    paths = []
    for v in range(2):
        img = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
        img[4 + 6 * v:20 + 6 * v, 3:25] = 128
        p = tmp_path / f"calib{v}.png"
        Image.fromarray(img).save(p)
        paths.append(str(p))
    rig = jproj.default_camera_rig(n_views=2, img_width=32, img_height=32)
    kw = dict(imu_to_rgb=rig[0], K=rig[1], vehicle_types=[0],
              bev_bound={"X": 25.2, "Y": 25.2, "Z": 2.5}, bev_feat_shape=8,
              bev_depth_dim=2, z_shift=-1.0, img_width=32, img_height=32,
              ori_img_width=32, ori_img_height=32)
    masked_j = jproj.reference_points_all_types(
        **kw, remove_ref_in_gray=True, bound_check_img_paths=paths)
    masked_t = tproj.reference_points_all_types(
        **kw, remove_ref_in_gray=True, bound_check_img_paths=paths)
    plain_t = tproj.reference_points_all_types(**kw)
    np.testing.assert_array_equal(masked_t, masked_j)
    np.testing.assert_array_equal(plain_t, jproj.reference_points_all_types(**kw))
    # a dropped point is zeroed before normalisation: (-1, -1)
    dropped = ((masked_t == -1).all(-1).sum()
               - (plain_t == -1).all(-1).sum())
    assert dropped > 0
    # the model takes the mask from its config
    from bevrender_tpu_torch.config import tiny_model_config
    from bevrender_tpu_torch.models.bevrender import reference_points

    cfg = tiny_model_config(remove_ref_in_gray=True,
                            bound_check_img_paths=paths)
    ours = reference_points(cfg)
    assert len(ours) == cfg.n_stages
    base = reference_points(tiny_model_config())
    assert all((a == -1).all(-1).sum() > (b == -1).all(-1).sum()
               for a, b in zip(ours, base))

