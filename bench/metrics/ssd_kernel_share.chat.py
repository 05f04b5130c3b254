"""The share of the hybrid decode step's recurrent updates, in per cent,
that the fused update kernel makes: its launches a replay
(``launches_per_replay["ssd_update_kernel"]``, the program's counter at
the capture) over the updates a replay makes (``ssm_update``, one a
layer).  100 when every layer's update is one launch of the kernel;
nothing where the program has no such counter.  Moves
``decode_tokens_per_s``."""


def read(run):
    per = run.info.get("launches_per_replay") or {}
    if "ssd_update_kernel" not in per or not per.get("ssm_update"):
        return None
    return per["ssd_update_kernel"] / per["ssm_update"] * 100.0
