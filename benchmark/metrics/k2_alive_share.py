"""The share of K2's lanes that carry a ray, %: 100 × the program's counter
``rt/k2/active`` ÷ ``rt/k2/lanes`` over the counted stretch that a counting
traffic (``progressive_counted``) runs after the traced one; None where
nothing was counted."""

from spantrace import k2_alive_share


def read(run):
    return k2_alive_share({name: sum(run.spans.get(name, ())) for name in
                           ("rt/k2/lanes", "rt/k2/active")})
