"""pipeline_overlap (program counters): the decoder's tokenize, prepare
(``fill_s``) and dispatch (``device_s``) host seconds summed over the
window, over the window's wall time.  About 1 when the three threads run
one after another; more when they overlap."""


def read(w):
    s = w.stats
    if not w.seconds or not s.get("pictures"):
        return None
    return (s["tokenize_s"] + s["fill_s"] + s["device_s"]) / w.seconds
