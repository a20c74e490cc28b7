"""``chip_smoke.py`` phase functions at small sizes on the CPU, its refusal
to run without a GPU, the compile-cache helper, and the on-card runs of
the smoke phases (marked ``gpu``)."""

import json
import os

import jax
import pytest

import chip_smoke as cs
from genparticlefilters_tpu.utils import compile_cache


def test_kernel_phase_interpreted():
    cs.kernel_phase(n=3000, cases=((43, 3000), (161, 3000), (43, 1500)),
                    interpret=True)


def test_headline_phase_small():
    cs.headline_phase(n=20_000, T=10, reps=8, big_n=20_000)


def test_resampling_phase_small():
    cs.resampling_phase(n=4096, T=10)


def test_config5_phase_small():
    # the 10-nat bound holds at N=1M; at N=100K the rehearsal spread is
    # -7.6 +- 2.2 nats, so this run checks the mechanics with 5 sd + bias
    cs.config5_phase(n=100_000, T=10, tol=20.0)


def test_config2_phase_small():
    cs.config2_phase(n=2000, T=20, reps=8)


def test_sharded_phase_on_virtual_devices():
    cs.sharded_phase(n_devices=4, per_device=1024, T=10)


def test_check_raises_on_failure(capsys):
    with pytest.raises(cs.PhaseFailed):
        cs.check("p", "x", 1.0, "<= 0.5", False)
    assert "FAIL" in capsys.readouterr().out


def test_exact_object_motion_is_normalized():
    import numpy as np
    post, lml = cs.exact_object_motion(np.linspace(0.0, 1.0, 6))
    assert post.shape == (6,) and ((post >= 0) & (post <= 1)).all()
    assert np.isfinite(lml)


def test_main_refuses_without_gpu(capsys):
    assert jax.devices()[0].platform != "gpu"
    assert cs.main([]) == 2
    out = capsys.readouterr()
    assert "needs a GPU" in out.err
    for line in out.out.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.use_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_defaults_to_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    assert compile_cache.use_compile_cache() == want
    assert ("jax_compilation_cache_dir", want) in calls


@pytest.mark.gpu
def test_kernel_phase_on_card(gpu):
    cs.kernel_phase(n=100_000, cases=((43, 100_000), (161, 50_000)))


@pytest.mark.gpu
def test_resampling_phase_on_card(gpu):
    cs.resampling_phase(n=100_000, T=10)


@pytest.mark.gpu
def test_headline_phase_on_card(gpu):
    cs.headline_phase(n=100_000, T=10, reps=8, big_n=100_000)
