# The query surface: ``repro_torch.core.query`` (query descriptions,
# ExecConfig, Plan) and ``repro_torch.core.engine.Engine.compile``.
# Re-exported lazily, so that ``import repro_torch.core`` loads neither
# the engine nor the kernel loader.


def __getattr__(name):
    if name in (
        "ExecConfig", "ObsConfig", "CapPolicy", "CapOverflow", "Plan",
        "TriplePatternQ", "JoinQ", "BgpQ", "ServeQ",
    ):
        from repro_torch.core import query

        return getattr(query, name)
    if name == "Engine":
        from repro_torch.core.engine import Engine

        return Engine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
