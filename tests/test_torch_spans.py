"""The port's spans (``utils.profiling.annotation``) on the CPU: where a
request and a training step emit them, how they nest, how many a
configuration implies, and that a profiled run computes the same bits as
an unprofiled one (the ``site`` span stays out of ``site_remat``'s
recomputed region)."""

import json

import pytest
import torch

from bevrender_tpu_torch.config import Config, tiny_model_config
from bevrender_tpu_torch.data.synthetic import SyntheticDataset
from bevrender_tpu_torch.inference.register import RegistrationPipeline
from bevrender_tpu_torch.training.trainer import Trainer
from bevrender_tpu_torch.utils import profiling as tprof

V, T, B = 2, 2, 2
# stage 0 runs its SCA view by view (G < 4), stage 1 folds the views (G = 4)
MODEL = dict(n_heads=(2, 4), n_groups=(1, 4), num_views=V)


def _config(site_remat="nothing") -> Config:
    cfg = Config()
    cfg.model = tiny_model_config(**MODEL)
    cfg.train.site_remat = site_remat
    return cfg


def _data(n: int) -> dict:
    return SyntheticDataset(n_items=n, num_views=V, window_num_imgs=T - 1,
                            img_height=32, img_width=32,
                            map_tile=32).batch(n)


def _sites_a_pass(m) -> int:
    """TSA once a layer; SCA once, or once a view where it has G < 4."""
    return sum(d * (1 + (1 if g >= 4 else m.num_views))
               for d, g in zip(m.depths, m.n_groups))


def _spans(tmp_path, fn) -> list:
    """(name, start, end) of every ``user_annotation`` that ``fn`` emits
    under ``utils.profiling.trace``, in order of start."""
    with tprof.trace(str(tmp_path)):
        fn()
    (path,) = tmp_path.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation")


def _inside(inner, outers) -> bool:
    return any(a <= inner[0] and inner[1] <= b for a, b, _ in outers)


@pytest.fixture(scope="module")
def pipe():
    p = RegistrationPipeline(_config(), device="cpu", seed=0)
    p.build_tile_database(list(_data(8)["map"]))
    return p


def test_a_request_emits_its_spans_nested(pipe, tmp_path):
    cfg = pipe.config.model
    batch = _data(B)
    spans = _spans(tmp_path, lambda: pipe.register(batch, top_k=3))
    named = {}
    for s in spans:
        named.setdefault(s[2], []).append(s)
    stages = [s for s in spans if s[2].startswith("encoder.stage")]
    assert len(named["register"]) == 1
    assert len(named["register.match"]) == len(named["model.decoder"]) == 1
    assert len(named["encoder.backbone"]) == T
    assert len(stages) == T * cfg.n_stages
    for s in range(cfg.n_stages):
        assert len(named[f"encoder.stage{s}"]) == T
    assert len(named["site"]) == T * _sites_a_pass(cfg) == 10
    request = named["register"]
    for name in ("register.match", "model.decoder", "encoder.backbone"):
        assert all(_inside(s, request) for s in named[name])
    assert all(_inside(s, request) for s in stages)
    assert all(_inside(s, stages) for s in named["site"])
    assert not any(_inside(s, named["site"]) for s in stages)
    # the match comes after the render
    assert named["model.decoder"][0][1] <= named["register.match"][0][0]


@pytest.mark.parametrize("site_remat", ["nothing", "dots"])
def test_a_training_step_emits_forward_backward_optimizer(tmp_path,
                                                          site_remat):
    trainer = Trainer(_config(site_remat), None, device="cpu")
    state = trainer.create_state(seed=0)
    batch = _data(B)
    spans = _spans(tmp_path, lambda: trainer.train_step(state, batch, 1))
    step = [s for s in spans if s[2] in ("train.forward", "train.backward",
                                         "train.optimizer")]
    assert [s[2] for s in step] == ["train.forward", "train.backward",
                                    "train.optimizer"]
    assert all(a[1] <= b[0] for a, b in zip(step, step[1:]))
    # the forward holds every site of its passes; the recompute emits none
    sites = [s for s in spans if s[2] == "site"]
    assert len(sites) == T * _sites_a_pass(trainer.config.model)
    assert all(_inside(s, step[:1]) for s in sites)


def test_a_dispatch_is_one_span(tmp_path):
    trainer = Trainer(_config(), None, device="cpu")
    state = trainer.create_state(seed=0)
    batch = {k: torch.as_tensor(v)[None] for k, v in _data(B).items()}
    spans = _spans(tmp_path,
                   lambda: trainer.train_step_multi(state, batch, 1))
    (dispatch,) = [s for s in spans if s[2] == "train.dispatch"]
    forward = [s for s in spans if s[2] == "train.forward"]
    assert len(forward) == 1 and _inside(forward[0], [dispatch])


@pytest.mark.parametrize("site_remat", ["nothing", "dots"])
def test_a_profiled_step_computes_the_same_bits(tmp_path, site_remat):
    batch = _data(B)
    runs = []
    for profiled in (False, True):
        trainer = Trainer(_config(site_remat), None, device="cpu")
        state = trainer.create_state(seed=0)
        if profiled:
            with tprof.trace(str(tmp_path)):
                state, _, render = trainer.train_step(state, batch, 1)
        else:
            state, _, render = trainer.train_step(state, batch, 1)
        net = state.net
        runs.append((render, {n: p.grad for n, p in net.named_parameters()},
                     {n: p.detach() for n, p in net.named_parameters()}))
    (r0, g0, p0), (r1, g1, p1) = runs
    assert torch.equal(r0, r1)
    assert g0.keys() == g1.keys()
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    assert all(torch.equal(p0[n], p1[n]) for n in p0)


def test_a_profiled_request_renders_the_same_bits(pipe, tmp_path):
    batch = _data(B)
    plain = pipe.register(batch, top_k=3)
    with tprof.trace(str(tmp_path)):
        traced = pipe.register(batch, top_k=3)
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
