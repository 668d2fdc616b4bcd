"""frames_per_s (host clock; the benchmark reads it per layer, as
``frames_per_s.tput``): every frame decoded in the window over the whole
window, which ends at the synchronize of the decode that crosses its
length."""


def read(w):
    return w.frames / w.seconds if w.seconds > 0 and w.frames else None
