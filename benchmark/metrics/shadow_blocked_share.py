"""The share of the NEE shadow rays that something blocks, %: 100 × the
program's counter ``rt/pt/shadow/blocked`` ÷ ``rt/pt/shadow/cast`` (lanes
that hit and face the sun) over the counted stretch that a counting traffic
(``progressive_counted``) runs after the traced one; None where the program
keeps no such counters or cast no shadow ray."""


def read(run):
    cast = sum(run.spans.get("rt/pt/shadow/cast", ()))
    blocked = run.spans.get("rt/pt/shadow/blocked")
    return 100.0 * sum(blocked) / cast if cast and blocked is not None else None
