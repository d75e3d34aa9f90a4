"""Device kernels per CUDA graph replay of the step, from the trace: kernels
whose correlation id is a cudaGraphLaunch's, the most any replay holds
(the profiler drops device records)."""

LAYER = "chain (core/chain.py, core/packing.py)"
UNIT = "kernels"
SOURCE = "device_trace"
MOVES = "block_p99_ms"

def read(obs):
    tr = obs.get("trace")
    if tr is None or not tr["replay_kernels"] or max(tr["replay_kernels"]) == 0:
        return None
    return max(tr["replay_kernels"])
