"""Host ms a frame from the frame's first call into the program to the
return of its last call before the wait (the window's mean; layer: the
entry, ``PathTracer``)."""


def read(run):
    issue = run.window.issue_s
    return sum(issue) / len(issue) * 1e3 if issue else None
