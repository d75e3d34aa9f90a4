"""The plain reference: one module per effect type of a chain config,
each with ``DEFAULTS`` (every parameter the type reads) and
``apply(x, params, fs)`` over x (..., channels, samples) in float64.
``parallel`` is the container and has ``apply_branches`` instead.  The
modules import nothing of the program."""
