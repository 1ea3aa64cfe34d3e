"""Milliseconds of EMOPipeline's denoise loop per DDIM step: its `timings["denoise_s"]`
(the host clock after a device synchronise at the phase's ends), summed over the window's
requests, over their steps."""

UNIT = "ms"
LAYER = "Serving pipeline (infer/pipeline.py, diffusion/)"
MOVES = "serve_frames_per_s"
SOURCE = "program_span"

def read(obs):
    t = [x for x in obs.get("timings") or [] if x]
    return 1e3 * sum(x["denoise_s"] for x in t) / obs["steps"] if t and obs["steps"] else None
