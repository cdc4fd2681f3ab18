"""A small module system on plain JAX pytrees.

It implements the part of `flax.nnx`'s API that this project uses, with the
same names and semantics, so the models are ordinary Python objects whose
arrays can be split out into nested-dict pytrees for `jax.jit` and merged
back:

- `Module`, `List`, `Dict`: containers. A module's children are its
  attributes (sorted by name); a `List`'s are its items.
- `Variable` and its kinds `Param` (trained), `BatchStat` (BatchNorm running
  statistics) and `RngState` (dropout key and counter). `v[...]` reads and
  `v[...] = x` writes the array.
- `split(module, *filters) -> (GraphDef, *states)`, `merge`, `state`,
  `update`, `clone`, `iter_modules`. A state is a nested dict of arrays keyed
  by attribute names and list indices. Filters are variable kinds, `...`
  (everything left) or `Not(kind)`.
- `value_and_grad`: differentiates a function of modules with respect to
  their `Param`s and writes the other variables it changed (BatchNorm
  statistics, dropout counters) back into the modules.
- `BatchNorm`, `Dropout`, `Rngs`, `relu`, `relu6`, `initializers`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

relu = jax.nn.relu
relu6 = jax.nn.relu6
initializers = jax.nn.initializers


class Variable:
    """A mutable box around one array."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def __getitem__(self, idx):
        return self.value if idx is Ellipsis else self.value[idx]

    def __setitem__(self, idx, value):
        if idx is not Ellipsis:
            raise IndexError("only v[...] = x assigns a Variable")
        self.value = value

    def __repr__(self):
        v = self.value
        desc = (f"{v.dtype}{list(v.shape)}" if hasattr(v, "shape")
                else repr(v))
        return f"{type(self).__name__}({desc})"


class Param(Variable):
    __slots__ = ()


class BatchStat(Variable):
    __slots__ = ()


class RngState(Variable):
    __slots__ = ()


class Not:
    """Filter matching the variables that `filter` does not match."""

    def __init__(self, filter):
        self.filter = filter


def _matches(filter, var: Variable) -> bool:
    if filter is Ellipsis:
        return True
    if isinstance(filter, Not):
        return not _matches(filter.filter, var)
    if isinstance(filter, type) and issubclass(filter, Variable):
        return isinstance(var, filter)
    raise TypeError(f"unsupported filter {filter!r}")


class Module:
    """Base class. Attributes that are Variables or Modules are children;
    everything else is static configuration."""

    def _children(self):
        return sorted(vars(self).items())

    def _set_child(self, key, value):
        setattr(self, key, value)

    def set_attributes(self, **attrs) -> None:
        """Set each attribute on every submodule that already has it."""
        for _, m in iter_modules(self):
            for k, v in attrs.items():
                if k in vars(m):
                    setattr(m, k, v)

    def train(self) -> None:
        self.set_attributes(use_running_average=False, deterministic=False)

    def eval(self) -> None:
        self.set_attributes(use_running_average=True, deterministic=True)


class List(Module):
    """A list of modules (or None) whose items are children keyed by
    index."""

    def __init__(self, items=()):
        self._items = list(items)

    def _children(self):
        return list(enumerate(self._items))

    def _set_child(self, key, value):
        self._items[key] = value

    def __getitem__(self, i):
        return self._items[i]

    def __setitem__(self, i, value):
        self._items[i] = value

    def __iter__(self):
        return iter(self._items)

    def __len__(self):
        return len(self._items)


class Dict(Module):
    """A mapping of names to modules, stored as attributes."""

    def __init__(self, **items):
        for k, v in items.items():
            setattr(self, k, v)

    def __getitem__(self, key):
        return getattr(self, key)

    def __setitem__(self, key, value):
        setattr(self, key, value)


def _check_static(node, key, value):
    if isinstance(value, (list, tuple, dict)):
        vals = value.values() if isinstance(value, dict) else value
        if any(isinstance(v, (Module, Variable)) for v in vals):
            raise TypeError(
                f"{type(node).__name__}.{key} holds modules or variables in "
                f"a plain {type(value).__name__}; use nnx.List / nnx.Dict")


def _iter_variables(node, path=()):
    for key, child in node._children():
        if isinstance(child, Variable):
            yield path + (key,), child
        elif isinstance(child, Module):
            yield from _iter_variables(child, path + (key,))
        else:
            _check_static(node, key, child)


def iter_modules(node, path=()):
    """(path, module) for every module in the tree, children before their
    parent, siblings in key order; the root comes last with path ()."""
    for key, child in node._children():
        if isinstance(child, Module):
            yield from iter_modules(child, path + (key,))
    yield path, node


def _set_nested(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _flatten_nested(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten_nested(v, path + (k,))
        else:
            yield path + (k,), v


def _partition(node, filters, *, complete: bool):
    states = [{} for _ in filters]
    for path, var in _iter_variables(node):
        for st, f in zip(states, filters):
            if _matches(f, var):
                _set_nested(st, path, var.value)
                break
        else:
            if complete:
                raise ValueError(f"variable {'.'.join(map(str, path))} "
                                 f"({type(var).__name__}) matched no filter")
    return states


class _Slot:
    """Where a variable of kind `cls` sits in a GraphDef skeleton."""

    def __init__(self, cls):
        self.cls = cls


def _skeleton(node):
    new = object.__new__(type(node))
    new.__dict__.update(vars(node))
    if isinstance(node, List):
        new._items = list(node._items)
    for key, child in node._children():
        if isinstance(child, Variable):
            new._set_child(key, _Slot(type(child)))
        elif isinstance(child, Module):
            new._set_child(key, _skeleton(child))
    return new


class GraphDef:
    """The static part of a module tree: classes, configuration and where
    each variable sits. `merge` rebuilds modules from it and states."""

    def __init__(self, node):
        self._skeleton = _skeleton(node)


def split(node, *filters):
    """(GraphDef, state per filter). Without filters: one state holding
    every variable. Each variable goes to the first filter it matches."""
    filters = filters or (Ellipsis,)
    return (GraphDef(node), *_partition(node, filters, complete=True))


def state(node, *filters):
    """The variables matching `filters` (one state per filter)."""
    states = _partition(node, filters or (Ellipsis,), complete=False)
    return states[0] if len(states) == 1 else tuple(states)


def _build(skel, path, values):
    new = object.__new__(type(skel))
    new.__dict__.update(vars(skel))
    if isinstance(skel, List):
        new._items = list(skel._items)
    for key, child in skel._children():
        if isinstance(child, _Slot):
            try:
                new._set_child(key, child.cls(values.pop(path + (key,))))
            except KeyError:
                raise ValueError(f"no value for variable "
                                 f"{'.'.join(map(str, path + (key,)))}") \
                    from None
        elif isinstance(child, Module):
            new._set_child(key, _build(child, path + (key,), values))
    return new


def merge(graphdef: GraphDef, *states):
    """A new module tree from `graphdef` with variables from `states`."""
    values = {}
    for st in states:
        values.update(_flatten_nested(st))
    node = _build(graphdef._skeleton, (), values)
    if values:
        raise ValueError(f"state entries match no variable: "
                         f"{sorted(map(str, values))[:5]}")
    return node


def update(node, *states) -> None:
    """Write the arrays of `states` into the matching variables of `node`."""
    by_path = dict(_iter_variables(node))
    for st in states:
        for path, value in _flatten_nested(st):
            try:
                by_path[path].value = value
            except KeyError:
                raise ValueError(f"no variable at "
                                 f"{'.'.join(map(str, path))}") from None


def clone(node):
    return merge(*split(node))


def to_pure_dict(state: dict) -> dict:
    """A state as nested plain dicts (a copy of the containers)."""
    return {k: to_pure_dict(v) if isinstance(v, dict) else v
            for k, v in state.items()}


def replace_by_pure_dict(state: dict, pure: dict) -> None:
    """Overwrite `state`'s leaves in place with `pure`'s. Keys are matched
    as strings too, since serialized dicts lose integer keys."""
    lookup = {str(k): v for k, v in pure.items()}
    for k, v in state.items():
        try:
            new = pure[k] if k in pure else lookup[str(k)]
        except KeyError:
            raise ValueError(f"pure dict has no entry {k!r}") from None
        if isinstance(v, dict):
            replace_by_pure_dict(v, new)
        else:
            state[k] = new


def value_and_grad(f, argnums=0, *, has_aux: bool = False):
    """Like `jax.value_and_grad` for functions of modules: gradients are
    states of the `Param`s of the modules at `argnums`; other variables
    that `f` changes are written back into those modules."""
    multi = isinstance(argnums, (tuple, list))
    nums = tuple(argnums) if multi else (argnums,)

    def wrapper(*args):
        parts = {i: split(args[i], Param, ...) for i in nums}

        def pure(params):
            new_args = list(args)
            for i in nums:
                graphdef, _, rest = parts[i]
                new_args[i] = merge(graphdef, params[i], rest)
            out = f(*new_args)
            loss, aux = out if has_aux else (out, None)
            rests = {i: state(new_args[i], Not(Param)) for i in nums}
            return loss, (aux, rests)

        (loss, (aux, rests)), grads = jax.value_and_grad(pure, has_aux=True)(
            {i: parts[i][1] for i in nums})
        for i in nums:
            update(args[i], rests[i])
        g = tuple(grads[i] for i in nums) if multi else grads[nums[0]]
        return ((loss, aux), g) if has_aux else (loss, g)

    return wrapper


class Rngs:
    """Seeded key source: `rngs.params()` (or any other stream name, or
    `rngs()`) returns a fresh key each call."""

    def __init__(self, seed: int = 0):
        self._key = jax.random.PRNGKey(seed)
        self._count = 0

    def __call__(self):
        key = jax.random.fold_in(self._key, self._count)
        self._count += 1
        return key

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.__call__


class BatchNorm(Module):
    """Batch normalization with `flax.nnx.BatchNorm`'s numerics: moments in
    at least float32 (Var = E[x²] - E[x]², clipped at 0), running averages
    `m = momentum*m + (1-momentum)*batch`, computation in `dtype` (default:
    promoted from the input and the variables)."""

    def __init__(self, num_features: int, *, use_running_average=False,
                 axis: int = -1, momentum: float = 0.99,
                 epsilon: float = 1e-5, dtype=None,
                 param_dtype=jnp.float32, rngs: Rngs | None = None):
        self.scale = Param(jnp.ones((num_features,), param_dtype))
        self.bias = Param(jnp.zeros((num_features,), param_dtype))
        self.mean = BatchStat(jnp.zeros((num_features,), jnp.float32))
        self.var = BatchStat(jnp.ones((num_features,), jnp.float32))
        self.num_features = num_features
        self.use_running_average = use_running_average
        self.axis = axis
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype

    def __call__(self, x):
        args = (x, self.mean[...], self.var[...], self.scale[...],
                self.bias[...])
        dt = self.dtype or jnp.result_type(*args)
        x, mean, var, scale, bias = (jnp.asarray(a, dt) for a in args)
        axis = self.axis % x.ndim
        red = tuple(i for i in range(x.ndim) if i != axis)
        if not self.use_running_average:
            xs = x.astype(jnp.promote_types(dt, jnp.float32))
            mean = xs.mean(red)
            var = jnp.maximum(0.0, (xs * xs).mean(red) - mean * mean)
            m = self.momentum
            self.mean[...] = m * self.mean[...] + (1 - m) * mean
            self.var[...] = m * self.var[...] + (1 - m) * var
        shape = [1] * x.ndim
        shape[axis] = x.shape[axis]
        mul = lax.rsqrt(var.reshape(shape) + self.epsilon) * scale.reshape(
            shape)
        y = (x - mean.reshape(shape)) * mul + bias.reshape(shape)
        return jnp.asarray(y, dt)


class Dropout(Module):
    """Inverted dropout. Its key and call counter live in `RngState`
    variables, so each training step draws a new mask."""

    def __init__(self, rate: float, *, deterministic: bool = False,
                 rngs: Rngs | None = None):
        self.rate = rate
        self.deterministic = deterministic
        self.key = RngState(rngs() if rngs is not None
                            else jax.random.PRNGKey(0))
        self.count = RngState(jnp.zeros((), jnp.uint32))

    def __call__(self, x):
        if self.deterministic or self.rate == 0.0:
            return x
        key = jax.random.fold_in(self.key[...], self.count[...])
        self.count[...] = self.count[...] + 1
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(key, keep, x.shape)
        return lax.select(mask, x / keep, jnp.zeros_like(x))
