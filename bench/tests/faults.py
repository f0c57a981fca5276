"""Faults planted under the timed path, one function each, to show that
the comparison with the reference catches them. Each records how to
take itself back out (:func:`undo`)."""
import dataclasses


_UNDO: list = []


def _set(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    _UNDO.append(lambda: setattr(obj, name, old))


def undo() -> None:
    while _UNDO:
        _UNDO.pop()()


def _frozen(u, spec, *, out=None, **kw):
    return u.clone() if out is None else out.copy_(u)


def unchanged_step() -> None:
    """Every stencil launch returns its state unchanged."""
    from repro_torch.engine import dispatch
    for name in ("temporal", "rowchunk", "dbuf", "shifted"):
        p = dispatch._REGISTRY[name]
        dispatch._REGISTRY[name] = dataclasses.replace(p, fn=_frozen)
        _UNDO.append(lambda name=name, p=p: dispatch._REGISTRY.__setitem__(
            name, p))


def altered_answer() -> None:
    """One cell of each answer is off by 0.5 where the answer is made:
    the engine's result, the server's host copy."""
    from repro_torch.engine import dispatch
    from repro_torch.serve import solve

    run_schedule = dispatch._execute_schedule

    def schedule(*a, **k):
        out = run_schedule(*a, **k)
        out[..., 1, 1] += 0.5
        return out

    host = solve._host

    def to_host(u):
        out = host(u)
        out[..., 1, 1] += 0.5
        return out

    _set(dispatch, "_execute_schedule", schedule)
    _set(solve, "_host", to_host)


def half_batch() -> None:
    """A served block advances only the first half of its slots; the
    rest keep their state."""
    from repro_torch.serve import solve
    batched = solve.run_batched

    def half(us, *a, **k):
        vs = batched(us, *a, **k)
        h = max(1, us.shape[0] // 2)
        vs[h:] = us[h:]
        return vs

    _set(solve, "run_batched", half)

