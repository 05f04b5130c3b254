"""Elements K1's blocks fetched from device memory over the window (the
program's counter, ``conv2d_offload.fetched_counter``, zeroed at the
window's start), over what the plans charge for the window's passes
(each layer's ``pixels_loaded x C_in`` plus its kernel set, a pass).
1.0 when K1 moves exactly what the plan charges.  Moves
``images_per_s``."""


def read(run):
    fetched, passes = run.window.get("fetched"), run.window.get("passes")
    if fetched is None or not passes:
        return None
    return fetched / (run.info["charged_per_pass"] * passes)
