"""The one platform rule (api.select_engine) and what the matcher reports
about it."""

import pytest

from multithreading_string_matching import Matcher
from multithreading_string_matching.api import select_engine


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
@pytest.mark.parametrize(
    "engine, want",
    [("pallas", "window"), ("window", "window"), ("ac", "ac"), ("kmp", "kmp")],
)
def test_supported_platforms(platform, engine, want):
    assert select_engine(engine, platform) == want


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_other_platforms_are_errors(platform):
    with pytest.raises(RuntimeError, match="no matcher path"):
        select_engine("window", platform)


@pytest.mark.parametrize(
    "patterns, engine, want",
    [
        ([b"http", b"xml"], "auto", "window"),
        ([b"A" * 300, b"http"], "auto", "ac"),
        ([b"http"], "pallas", "window"),
        ([b"http"], "ac", "ac"),
    ],
)
def test_matcher_resolution_and_explain(patterns, engine, want):
    m = Matcher(patterns, engine=engine)
    assert m._resolve_engine(None) == want
    ex = m.explain()
    assert ex["engine_resolved"] == want
    assert ex["engine_requested"] == engine
    assert ex["platform"] == "cpu"


@pytest.mark.parametrize(
    "engine, want", [("window", "window"), ("pallas", "ac"), ("auto", "ac"),
                     ("ac", "ac"), ("kmp", "ac")],
)
def test_flow_stream_engine_on_cpu(engine, want):
    """On a CPU host only an explicit 'window' request streams flows
    through the window halo rounds; everything else carries AC state."""
    assert Matcher([b"http"], engine=engine).flow_stream_engine() == want


def test_flow_stream_engine_on_gpu(monkeypatch):
    """On a GPU the window family streams flows through halo rounds."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert Matcher([b"http"]).flow_stream_engine() == "window"
    assert Matcher([b"http"], engine="ac").flow_stream_engine() == "ac"
    big = Matcher([b"%06d" % i for i in range(25_010)], engine="auto")
    big.AC_GOTO_WALL_BYTES = 1 << 40
    assert big.flow_stream_engine() == "ac"
