"""Milliseconds per request of EMOPipeline's phases outside the denoise loop: prompt,
prepare (VAE encode, audio), face mask, the writer's banks and the decode, from its
`timings`, summed over the window's requests, over their count."""

PHASES = ("prompt_s", "prepare_s", "face_mask_s", "ref_banks_s", "decode_s")

UNIT = "ms"
LAYER = "Serving pipeline (infer/pipeline.py, diffusion/)"
MOVES = "serve_frames_per_s"
SOURCE = "program_span"


def read(obs):
    t = [x for x in obs.get("timings") or [] if x]
    return 1e3 * sum(x.get(k, 0.0) for x in t for k in PHASES) / len(t) if t else None
