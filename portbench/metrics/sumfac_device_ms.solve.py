"""Device ms per solve of the operations launched inside the
sum-factorised operator's ``sumfac.apply`` spans, over the device stretch
of solves; None where the program has no such span."""

from portbench.spans import device_stretch, launched_in


def read(ctx):
    st = device_stretch(ctx)
    if st is None or not st.device:
        return None
    n_solves = sum(s.name == "solve" for s in st.spans)
    apply = [s.name == "sumfac.apply" for s in st.spans]
    if not n_solves or not any(apply):
        return None
    ns = sum(e - s for (s, e, *_), i in zip(st.device, launched_in(st))
             if i is not None and i >= 0 and apply[i])
    return ns / 1e6 / n_solves
