"""Lowered-module determinism: the persistent compilation cache is keyed
by the serialized module, and Pallas kernel bodies embed Python traceback
locations — so without compile_cache's traceback stripping, the SAME
graph built from two different call sites lowers to different bytes and
silently misses the cache (`cli preheat`'s corpus would never warm the UI
engine's identical graphs). These tests pin the property on the real GPU
lowering, produced without a card via jax.export with platforms=["cuda"]
(the Triton kernel payload survives export, unlike the interpret mode
the CPU backend would take)."""

import jax
import jax.numpy as jnp
import pytest
from jax.export import DisabledSafetyCheck

from sdrpp_tpu.utils.compile_cache import enable_persistent_cache


@pytest.fixture(autouse=True)
def _cache_on(tmp_path, monkeypatch):
    monkeypatch.delenv("SDRPP_TPU_NO_CACHE", raising=False)
    enable_persistent_cache(cache_dir=tmp_path / "cache")
    # the engaged chunk-parallel kernel is what embeds the Triton payload
    from sdrpp_tpu.ops import scans_pallas as sp
    monkeypatch.setattr(sp, "pallas_gpu_supported", lambda: True)
    yield


_TRITON = "__gpu$xla.gpu.triton"


def _export(fn, *args) -> str:
    return jax.export.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[DisabledSafetyCheck.custom_call(_TRITON)])(
        *args).mlir_module()


def _export_pll_from_site_a() -> str:
    from sdrpp_tpu.ops.scans_pallas import PLLChunked

    pll = PLLChunked(0.01)
    st = pll.init_state()
    x = jnp.zeros(32768, jnp.complex64)
    return _export(pll, st, x)


def _export_pll_from_site_b() -> str:
    # deliberately a DIFFERENT call site (function, lines) building the
    # exact same graph
    from sdrpp_tpu.ops.scans_pallas import PLLChunked

    pll = PLLChunked(0.01)

    def wrapped():
        st = pll.init_state()
        x = jnp.zeros(32768, jnp.complex64)
        return _export(pll, st, x)

    return wrapped()


def test_mosaic_payload_present():
    assert _TRITON in _export_pll_from_site_a()


def test_same_graph_different_call_sites_lower_identically():
    a = _export_pll_from_site_a()
    b = _export_pll_from_site_b()
    assert a == b, "call-site tracebacks leak into the lowered module"


def test_repeated_construction_lowers_identically():
    a = _export_pll_from_site_a()
    b = _export_pll_from_site_a()
    assert a == b
