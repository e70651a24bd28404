"""The port's config against the JAX package's, on the CPU.

Every field of every section of ``picotron_tpu.config.Config`` must be
declared by the port's ``Config``, refused at load when set to a value the
port does not behave as (``REFUSED_AT_LOAD``), or listed as inert with its
reason (``INERT_FIELDS``): a config never runs on the port without the
behaviour it asks for. The refusals name their field (the dense fallback
is refused where serving starts, ``Config.check_servable``), and the
bundled configs (``configs/*/config.json``) all load.
"""

import dataclasses
import os

import pytest
import torch

from picotron_tpu.config import Config as JaxConfig
from picotron_tpu_torch import config as port_config
from picotron_tpu_torch.config import Config
from picotron_tpu_torch.inference.batcher import ContinuousBatcher, Request
from picotron_tpu_torch.inference.engine import InferenceEngine
from picotron_tpu_torch.models import llama
from picotron_tpu_torch.resilience.chaos import ServingChaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.listdir(os.path.join(REPO, "configs")))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _fields(cls) -> dict:
    """section -> the names of its fields, for a top-level ``Config``."""
    return {f.name: [g.name for g in dataclasses.fields(f.default_factory)]
            for f in dataclasses.fields(cls)}


JAX_FIELDS = [(section, name)
              for section, names in _fields(JaxConfig).items()
              for name in names]


@pytest.mark.parametrize("section, name", JAX_FIELDS)
def test_every_jax_field_is_declared_refused_or_inert(section, name):
    declared = name in _fields(Config).get(section, ())
    refused = (section, name) in port_config.REFUSED_AT_LOAD
    inert = (section, name) in port_config.INERT_FIELDS
    assert declared + refused + inert == 1, (
        f"{section}.{name}: declared {declared}, refused {refused}, "
        f"inert {inert} (exactly one must hold)")
    if inert:
        assert port_config.INERT_FIELDS[(section, name)].strip()


def test_the_tables_name_only_jax_fields_the_port_does_not_declare():
    ours = _fields(Config)
    for section, name in (*port_config.REFUSED_AT_LOAD,
                          *port_config.INERT_FIELDS):
        assert (section, name) in JAX_FIELDS, (section, name)
        assert name not in ours.get(section, ()), (section, name)


TINY_MODEL = {"num_hidden_layers": 1, "num_attention_heads": 2,
              "num_key_value_heads": 2, "hidden_size": 16,
              "intermediate_size": 32, "vocab_size": 32,
              "max_position_embeddings": 16, "dtype": "float32"}


@pytest.mark.parametrize("section, name, value, where", [
    ("resilience", "dispatch_attempts", 2, "serve"),
    ("inference", "attend_fallback", True, "serve"),
    ("inference", "key_schedule", "slot", "load"),
    ("inference", "overlap", True, "load"),
])
def test_unhonoured_values_are_refused(section, name, value, where):
    """A value the port does not behave as is refused: the dense fallback
    where serving starts (the JAX package's own to_dict writes it at its
    default, true, so the load takes it and the engine refuses it:
    ``Config.check_servable``). The dispatch retries, the per-slot key
    schedule and the overlap pipeline, once refused here, are served now:
    they load, pass ``check_servable``, and the engine and batcher built
    from them act on them."""
    refused = rf"{section}\.{name}=.* is not in the PyTorch port yet"
    raw = {"model": TINY_MODEL, section: {name: value}}
    if (section, name) in port_config.REFUSED_AT_LOAD:
        with pytest.raises(ValueError, match=refused):
            Config.from_dict(raw)
        only = port_config.REFUSED_AT_LOAD[(section, name)]
    elif name == "attend_fallback":
        cfg = Config.from_dict(raw)
        with pytest.raises(ValueError, match=refused):
            cfg.check_servable()
        with pytest.raises(ValueError, match=refused):
            InferenceEngine(cfg, "cpu", slots=1)
        only = (getattr(getattr(Config(), section), name),)
    else:
        cfg = Config.from_dict(raw)
        cfg.check_servable()
        engine = InferenceEngine(cfg, "cpu", slots=1)
        if name == "key_schedule":
            assert engine.key_schedule == "slot"
        elif name == "overlap":
            # the pipeline, on the slot schedule "auto" resolves to: a
            # round in flight while the next is issued, drained at the end
            assert engine.overlap and engine.key_schedule == "slot"
            params = llama.init_params(engine.cfg.model, seed=0,
                                       device=engine.device)
            b = ContinuousBatcher(engine, params)
            assert engine.defer_advance
            b.submit(Request("a", [1, 2, 3], max_new_tokens=9))
            inflight = []
            while b.busy:
                b.step()
                inflight.append(b._inflight is not None)
            res = b.take_results()
            assert len(res["a"].tokens) == 9 and any(inflight)
            assert b.stats()["overlap"]["enabled"]
        else:
            # one injected fault at the first decode round: the second of
            # the two attempts lands it
            engine.hooks = ServingChaos(Config.from_dict({"resilience": {
                "chaos_dispatch_raise_round": 1}}).resilience)
            params = llama.init_params(engine.cfg.model, seed=0,
                                       device=engine.device)
            b = ContinuousBatcher(engine, params, sleep=lambda s: None)
            res = b.run([Request("a", [1, 2, 3], max_new_tokens=2)])
            assert res["a"].finish_reason == "length"
            assert len(res["a"].tokens) == 2
            assert engine.hooks.round == 2 and b.decode_dispatches == 1
        only = ()
    # the values the port does behave as load and serve
    for ok in only:
        cfg = Config.from_dict({"model": TINY_MODEL, section: {name: ok}})
        cfg.check_servable()
        InferenceEngine(cfg, "cpu", slots=1)


def test_a_jax_dump_loads_for_training():
    """A JAX config's to_dict, every field at the JAX default (the dense
    fallback on), loads and trains; only serving refuses it."""
    raw = JaxConfig.from_dict({"model": TINY_MODEL,
                               "training": {"seq_length": 8}}).to_dict()
    cfg = Config.from_dict(raw)
    cfg.check_trainable()
    with pytest.raises(ValueError, match="not in the PyTorch port yet"):
        cfg.check_servable()


@pytest.mark.parametrize("name", CONFIGS)
def test_bundled_config_loads(name):
    cfg = Config.from_json(os.path.join(REPO, "configs", name,
                                        "config.json"))
    assert cfg.model.num_hidden_layers > 0
