"""Mean host microseconds of a conv call's ``conv.launch`` span (the
device context, the stream and the C call that launches K1), in the
stream cell's traced sub-window, from the program's host spans
(``harness/spans.py``)."""
from harness import spans


def read(run):
    if run.info.get("mode") != "stream":
        return None
    split = spans.conv_split_us(spans.recorded())
    return None if split is None else split[1]
