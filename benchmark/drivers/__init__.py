"""One driver per kind of traffic (``traffic/<mix>.json`` names its
kind); each has ``run(ctx) -> harness.Outcome``."""
