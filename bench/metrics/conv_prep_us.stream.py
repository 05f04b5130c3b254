"""Mean host microseconds of a conv call outside its launch, in the stream
cell's traced sub-window: each ``conv.run`` span (``EmittedConv.run``)
less its ``conv.launch`` child (the device context, the stream and the C
call), from the program's host spans (``harness/spans.py``).  The work
fixed per plan that every call redoes."""
from harness import spans


def read(run):
    if run.info.get("mode") != "stream":
        return None
    split = spans.conv_split_us(spans.recorded())
    return None if split is None else split[0]
