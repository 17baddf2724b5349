"""Profiling + checkpoint utilities."""

import time

import jax.numpy as jnp
import numpy as np

from cilqr_tpu.utils import checkpoint, profiling


def test_phase_timer():
    t = profiling.PhaseTimer()
    with t.phase("a"):
        time.sleep(0.01)
    with t.phase("a"):
        time.sleep(0.01)
    t.record("b", 0.5)
    s = t.summary()
    assert s["a"]["count"] == 2
    assert s["a"]["mean_ms"] >= 9.0
    assert s["b"]["total_ms"] == 500.0
    assert "a" in t.dump()


def test_timed_blocks_async_dispatch():
    t = profiling.PhaseTimer()
    x = jnp.ones((256, 256))
    out = t.timed("matmul", lambda: x @ x)
    assert out.shape == (256, 256)
    assert t.summary()["matmul"]["count"] == 1


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "U_warm": jnp.ones((40, 2)) * 0.5,
        "key": np.arange(4, dtype=np.uint32),
        "step": np.asarray(17),
        "nested": {"J": jnp.asarray(3.5)},
    }
    p = tmp_path / "ckpt_000017.npz"
    checkpoint.save(str(p), tree)
    like = {
        "U_warm": jnp.zeros((40, 2)),
        "key": np.zeros(4, dtype=np.uint32),
        "step": np.asarray(0),
        "nested": {"J": jnp.asarray(0.0)},
    }
    back = checkpoint.restore(str(p), like)
    np.testing.assert_allclose(np.asarray(back["U_warm"]), 0.5)
    assert int(back["step"]) == 17
    assert float(back["nested"]["J"]) == 3.5


def test_checkpoint_shape_mismatch(tmp_path):
    p = tmp_path / "c.npz"
    checkpoint.save(str(p), {"a": np.zeros((3,))})
    try:
        checkpoint.restore(str(p), {"a": np.zeros((4,))})
        raised = False
    except ValueError:
        raised = True
    assert raised


def test_latest_step(tmp_path):
    assert checkpoint.latest_step(str(tmp_path)) is None
    for s in (3, 11, 7):
        checkpoint.save(str(tmp_path / f"ckpt_{s:06d}.npz"), {"x": np.zeros(1)})
    assert checkpoint.latest_step(str(tmp_path)) == 11
    meta = {"step": 11, "scenario": "long"}
    checkpoint.save_metadata(str(tmp_path / "meta.json"), meta)
    assert checkpoint.load_metadata(str(tmp_path / "meta.json")) == meta


def test_compile_cache_warns_on_unwritable_dir(monkeypatch, tmp_path):
    """An unusable cache dir must warn, not silently degrade."""
    import warnings

    from cilqr_tpu.utils import compile_cache

    blocker = tmp_path / "blocker"
    blocker.write_text("")  # a FILE where a directory is required
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(blocker / "sub"))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        compile_cache.enable_compilation_cache()
    assert any("compilation cache disabled" in str(x.message) for x in w)


def test_compile_cache_path(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits at
    a fixed path inside the checkout, which .gitignore lists."""
    import pathlib

    from cilqr_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert compile_cache.cache_dir() == str(tmp_path / "c")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    root = pathlib.Path(__file__).resolve().parents[1]
    assert pathlib.Path(compile_cache.cache_dir()) == root / ".jax_cache"
    assert ".jax_cache/" in (root / ".gitignore").read_text().split()


def test_compile_cache_enables_jax_config(monkeypatch, tmp_path):
    import jax

    from cilqr_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    try:
        compile_cache.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
        assert (tmp_path / "c").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
