"""The requests a traffic file can name (its ``request`` key), one module
each, found by that name.  A module gives:

  inputs(traffic, system, seed, problem) -> {"pool": (k, n) tensor, ...}
      the inputs, made from ``seed`` on the system's device; ``problem()``
      builds the plain reference's problem where the inputs need it; every
      entry is indexed by pool row, and the check gets the kept rows of each;
  serve(system, cfg, traffic) -> fn(input) -> (answer, counters)
      one request, synchronised; counters hold "ok" (False: a failed one);
  summary(counters) -> str
      a line about the window's requests;
  judge(problem, kept) -> {reading: value}
      the readings of the kept answers against the reference, each held
      against its limit (limits/<cell>.json); ``kept`` has "answers" (k, n)
      and the kept rows of every input, in the program's dof numbering,
      and "index", the pool row of each.
"""
