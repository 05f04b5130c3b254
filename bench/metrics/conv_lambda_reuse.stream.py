"""The share, in per cent, of the program's CUDA ``EmittedConv.run`` calls
since the process started that reused their layer's Λ, in the stream
cell: the program's counter ``conv2d_offload.LAMBDA`` (``built``,
``reused``).  Nothing where the program has no such counter or made no
such call.  Moves ``images_per_s``: a call that reuses Λ enqueues no
transpose."""


def read(run):
    if run.info.get("mode") != "stream":
        return None
    from repro_torch.kernels import conv2d_offload
    counts = getattr(conv2d_offload, "LAMBDA", None)
    if not counts:
        return None
    calls = counts["built"] + counts["reused"]
    return counts["reused"] / calls * 100.0 if calls else None
