"""Applies of the sum-factorised operator per solve: the ``sumfac.apply``
spans over the ``solve`` spans of the host stretch; None where the program
opens no such span."""

from portbench.spans import host_stretch


def read(ctx):
    st = host_stretch(ctx)
    if st is None:
        return None
    n_solves, n_applies = st.counts.get("solve", 0), st.counts.get("sumfac.apply", 0)
    if not n_solves or not n_applies:
        return None
    return n_applies / n_solves
