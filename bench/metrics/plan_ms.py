"""Host milliseconds of the set-up's plan: ``plan_emitable_network`` over
the configuration's layers and ``emit_layer_kernel`` of each, in a fresh
process, so with no plan cached.  Moves ``setup_s``."""


def read(run):
    plan_s = run.spans.get("plan_s")
    return None if plan_s is None else plan_s * 1e3
