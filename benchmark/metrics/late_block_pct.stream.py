"""Share of the window's due blocks that were skipped, or held later than
the pipelined mode's promise of two block periods after they fell due."""

LAYER = "client (the benchmark's load generator)"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "block_p99_ms"

def read(obs):
    c = obs["counters"]
    return 100.0 * c["late_blocks"] / c["due_blocks"] if c.get("due_blocks") else None
