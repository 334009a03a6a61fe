"""Training: AdamW on fp32 masters, the microbatched train step, the
numeric parts of gradient compression and the guarded loop."""
