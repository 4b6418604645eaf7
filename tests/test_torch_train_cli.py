"""The port's configuration round trips and training CLI, on the CPU.

The config is held against the JAX package's key for key (defaults, the
reference dict, JSON written by the JAX package, the config.yaml
snapshot); the inference split against sklearn's ``train_test_split``
(imported only here); ``main`` trains the tiny model for one epoch from a
CSV trace and PNG frames, and from synthetic data. No JAX model is
trained.
"""

import dataclasses
import json
import tempfile

import numpy as np
import pytest
import torch
from PIL import Image
from sklearn.model_selection import train_test_split

from bevrender_tpu import config as jconfig
from bevrender_tpu_torch import config as tconfig
from bevrender_tpu_torch import train as ttrain
from bevrender_tpu_torch.data import native
from bevrender_tpu_torch.data.synthetic import SyntheticDataset
from bevrender_tpu_torch.training.trainer import Trainer


def _jax_config():
    """A JAX config with non-default values in every section."""
    cfg = jconfig.Config()
    cfg.model = jconfig.tiny_model_config(remove_ref_in_gray=True,
                                          bound_check_img_paths=["a.png"],
                                          vehicle_type_code=1)
    cfg.data.overlap = True
    cfg.data.map_path = {"june": "map.png"}
    cfg.data.map_month = "june"
    cfg.data.camera_norm_std = (0.3, 0.3, 0.3)
    cfg.data.on_device_preprocess = "cast"
    cfg.train.k_fold = 3
    cfg.train.ckpt_dir = "/data/ckpt"
    return cfg


def test_data_config_defaults_equal_jax():
    ours = dataclasses.asdict(tconfig.DataConfig())
    assert ours == dataclasses.asdict(jconfig.DataConfig())
    assert len(ours) == 26
    jm, tm = jconfig.ModelConfig(), tconfig.ModelConfig()
    for name in ("vehicle_type_code", "remove_ref_in_gray",
                 "bound_check_img_paths"):
        assert getattr(tm, name) == getattr(jm, name)
    assert tconfig.Config()._REF_MAP == jconfig.Config()._REF_MAP


def test_reference_dict_equals_jax_and_inverts():
    jcfg = _jax_config()
    ref = jcfg.to_reference_dict()
    cfg = tconfig.Config.from_reference_dict(ref)
    assert cfg.to_reference_dict() == ref
    assert list(cfg.to_reference_dict()) == list(ref)
    assert cfg.model.bev_shapes == jcfg.model.bev_shapes  # lists -> tuples
    assert isinstance(cfg.data.camera_norm_std, tuple)
    # the defaults: equal but for the checkpoint directory, whose default
    # is the system's temporary directory here
    d_ours = tconfig.Config().to_reference_dict()
    d_jax = jconfig.Config().to_reference_dict()
    assert {k for k in d_ours if d_ours[k] != d_jax[k]} == {"CKPT_DIR"}


def test_from_json_reads_jax_json():
    jcfg = _jax_config()
    cfg = tconfig.Config.from_json(jcfg.to_json())
    assert cfg.to_reference_dict() == jcfg.to_reference_dict()
    assert not hasattr(cfg.model, "use_pallas")
    again = tconfig.Config.from_json(cfg.to_json())
    assert again == cfg
    assert json.loads(cfg.to_json())["data"]["on_device_preprocess"] == "cast"


def test_config_snapshot_byte_equal(tmp_path, capsys):
    jcfg = _jax_config()
    cfg = tconfig.Config.from_reference_dict(jcfg.to_reference_dict())
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jcfg.save_config_given_dir(str(tmp_path / "j"))
    cfg.save_config_given_dir(str(tmp_path / "t"))
    assert ((tmp_path / "t" / "config.yaml").read_bytes()
            == (tmp_path / "j" / "config.yaml").read_bytes())
    assert cfg.print_config() == jcfg.print_config()


@pytest.mark.parametrize("n,ratio,seed", [(10, 0.1, 15213), (28, 0.25, 0),
                                          (97, 0.3, 7), (5, 0.5, 1)])
def test_inference_split_equals_sklearn(n, ratio, seed):
    train_idx, inf_idx = ttrain.split_inf_set(n, ratio, seed)
    ref_train, ref_inf = train_test_split(np.arange(n), test_size=ratio,
                                          random_state=seed)
    np.testing.assert_array_equal(train_idx, ref_train)
    np.testing.assert_array_equal(inf_idx, ref_inf)


def _file_dataset(root, n=14, views=2, vh=16, vw=16):
    """tests/test_train_cli.py's trace: 14 frames at 4 Hz, two views."""
    (root / "rgb").mkdir(parents=True)
    (root / "map").mkdir(parents=True)
    rows, ts = [], 1_700_000_000_000_000
    rng = np.random.default_rng(0)
    for i in range(n):
        rows.append([ts, 0, 500.0 + i, 400.0 + i, -10.0, 0.0, 0.0, 0.1 * i])
        wide = rng.uniform(0, 255, (vh, views * vw, 3)).astype(np.uint8)
        Image.fromarray(wide).save(root / "rgb" / f"{ts}.png")
        tile = rng.uniform(0, 255, (32, 32, 3)).astype(np.uint8)
        Image.fromarray(tile).save(root / "map" / f"{ts}.png")
        ts += 250_000
    np.savetxt(root / "gps.csv", np.asarray(rows, np.float64), delimiter=",")


def _file_config(tmp_path, **data):
    root = tmp_path / "data"
    _file_dataset(root)
    cfg = tconfig.Config()
    cfg.model = tconfig.tiny_model_config(num_views=2)
    dc = cfg.data
    dc.gps_file_path = str(root / "gps.csv")
    dc.rgb_img_dir, dc.map_img_dir = str(root / "rgb"), str(root / "map")
    dc.map_jgw_info = (1.0, 0.0, 0.0, -1.0, 0.0, 1000.0)
    dc.map_width = dc.map_height = 1200
    dc.window_timespin, dc.window_num_imgs, dc.overlap = 1.0, 2, True
    dc.num_views, dc.resize_img_height, dc.resize_img_width = 2, 32, 64
    for k, v in data.items():
        setattr(dc, k, v)
    tc = cfg.train
    tc.batch_size, tc.k_fold, tc.epoch_per_fold = 2, 2, 1
    tc.loss_type, tc.ckpt_dir = "MSE", str(tmp_path / "ckpt")
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    return path


@pytest.mark.parametrize("preprocess", [False, True])
def test_cli_trains_on_file_dataset(tmp_path, preprocess):
    """One epoch (``--epochs 2``) of the tiny model from a trace, with the
    host route and with the device route; the inference split saved."""
    path = _file_config(tmp_path, on_device_preprocess=preprocess)
    cfg = json.loads(path.read_text())
    cfg["train"]["split_inf_set"] = True
    path.write_text(json.dumps(cfg))
    state = ttrain.main(["--config", str(path), "--epochs", "2",
                         "--device", "cpu"])
    assert state.step > 0
    assert all(torch.isfinite(p).all() for p in state.net.parameters())
    (work,) = list((tmp_path / "ckpt").iterdir())
    assert (work / "config.yaml").read_text().startswith("SEED:\t15213\n")
    assert list(work.glob("*epoch_0*.pt"))
    inf = np.load(work / "inference_indices.npy")
    assert len(inf) == 2  # ceil(0.1 * 11 windows)


def test_cli_synthetic_tiny(tmp_path, monkeypatch):
    """``--synthetic --tiny``: the work directory goes under the system's
    temporary directory (here the test's)."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    state = ttrain.main(["--synthetic", "--tiny", "--epochs", "2",
                         "--device", "cpu"])
    assert state.step == 6  # k_fold 5: 12 of 16 samples train, 2 a batch
    (work,) = list((tmp_path / "bevrender_ckpt").iterdir())
    assert (work / "config.yaml").exists()


def test_cli_refuses_cpu_by_default_and_distributed(tmp_path):
    path = _file_config(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.main(["--config", str(path)])
    with pytest.raises(NotImplementedError, match="item 8"):
        ttrain.main(["--config", str(path), "--distributed", "--device",
                     "cpu"])
    assert not (tmp_path / "ckpt").exists()


def test_val_images_and_log_image_without_pil(tmp_path):
    """``save_val_images`` writes through the port's encoder: PIL reads
    back the pixels PIL would have written; ``get_log_image``'s resize is
    the native triangle filter, within 2 levels of PIL's BILINEAR."""
    cfg = tconfig.Config()
    cfg.model = tconfig.tiny_model_config()
    cfg.train.work_dir = str(tmp_path)
    ds = SyntheticDataset(n_items=4, num_views=2, window_num_imgs=1,
                          img_height=32, img_width=32, map_tile=32)
    trainer = Trainer(cfg, ds, device="cpu")
    state = trainer.create_state(seed=0)
    from bevrender_tpu_torch.data.prefetch import DataLoader

    loader = DataLoader(ds, 2, num_workers=1)
    trainer.save_val_images(state, loader, epoch=0)
    for batch in loader:
        _, _, _, out = trainer.eval_step(state, batch)
        for render, ts in zip(out.numpy(), batch["timestamp"]):
            want = (np.clip(render, 0, 1) * 255).astype(np.uint8)
            path = tmp_path / "best_epoch_val" / f"{int(ts)}.png"
            np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
    b = ds.batch(1)
    render = np.random.default_rng(0).uniform(0, 1, (32, 32, 3)).astype(
        np.float32)
    cams = b["camera"][0, -1]  # (V, 32, 32, 3)
    img = trainer.get_log_image(render, b["map"][0], cams)
    assert img.shape == (64, 96, 3)
    wide = np.concatenate(list((cams - cams.min())
                               / (cams.max() - cams.min())), axis=1)
    u8 = (wide * 255).astype(np.uint8)
    ours = native.resize_u8(u8, 32, 96)
    np.testing.assert_array_equal((img[:32] * 255).round().astype(np.uint8),
                                  ours)
    pil = np.asarray(Image.fromarray(u8).resize((96, 32), Image.BILINEAR))
    assert np.abs(ours.astype(int) - pil.astype(int)).max() <= 2
