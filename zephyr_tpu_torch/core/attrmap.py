'''
Declarative configuration core for zephyr_tpu_torch.

A copy of ``zephyr_tpu.core.attrmap`` (numpy only; the port never imports
the JAX package). It re-implements the semantics of the
reference's "galoshes" configuration layer, which is the load-bearing config
system of uwoseis/zephyr (see reference zephyr/backend/base.py:17-29 and
zephyr/backend/discretization.py:23-31 for how initMap tables are declared,
and zephyr/backend/distributors.py:36,72,254 for maskKeys usage).

Semantics provided:

- ``AttributeMapper``: every class declares an ``initMap`` table
  ``{key: (required, renameAs, storeType)}``. The constructor takes a single
  ``systemConfig`` dict and materializes typed attributes. initMap tables
  aggregate across the MRO (subclasses only declare their new keys).
- ``BaseSCCache``: adds a stored ``systemConfig``, a ``cacheItems`` list of
  attribute names cleared by ``clearCache()``, and ``maskKeys`` (keys that
  are not forwarded into subProblem configs).
- ``SCFilter(cls)``: filters a config dict down to the keys a class accepts,
  raising if required keys are missing.
'''

import copy

import numpy as np

_NUMERIC_SCALARS = (int, float, complex, np.integer, np.floating,
                    np.complexfloating)


def _coerce(value, storeType):
    'Coerce a config value to the declared storage type.'

    if storeType is None:
        return value

    if storeType in (tuple, list):
        return storeType(value)

    if storeType in (bool, str, dict, set):
        return storeType(value)

    # numpy scalar types: cast arrays elementwise, scalars to numpy scalars
    if isinstance(value, np.ndarray):
        return value.astype(storeType)
    if isinstance(value, (list, tuple)) and value and \
            isinstance(value[0], _NUMERIC_SCALARS):
        return np.asarray(value, dtype=storeType)
    try:
        return storeType(value)
    except TypeError:
        # e.g. class objects stored with a numeric storeType; keep verbatim
        return value


def _aggregate_initmap(cls):
    'Aggregate initMap dicts over the MRO (subclasses take precedence).'

    table = {}
    for klass in reversed(cls.__mro__):
        table.update(vars(klass).get('initMap', {}))
    return table


def _aggregate_set(cls, name):
    out = set()
    for klass in reversed(cls.__mro__):
        out.update(vars(klass).get(name, ()))
    return out


def _aggregate_list(cls, name):
    out = []
    for klass in reversed(cls.__mro__):
        for item in vars(klass).get(name, ()):
            if item not in out:
                out.append(item)
    return out


class AttributeMapper(object):
    '''
    Base class that materializes typed attributes from a systemConfig dict
    according to the aggregated ``initMap`` of its class hierarchy.
    '''

    initMap = {}

    def __init__(self, systemConfig, *args, **kwargs):

        if systemConfig is None:
            systemConfig = {}

        table = _aggregate_initmap(self.__class__)

        for key, (required, rename, storeType) in table.items():
            if key in systemConfig:
                attr = rename if rename is not None else key
                setattr(self, attr, _coerce(systemConfig[key], storeType))
            elif required:
                raise ValueError(
                    '%s requires systemConfig key %r'
                    % (self.__class__.__name__, key))

    @classmethod
    def initTable(cls):
        'The aggregated initMap over the MRO.'
        return _aggregate_initmap(cls)


class BaseSCCache(AttributeMapper):
    '''
    AttributeMapper subclass that stores its systemConfig and supports
    cache-clearing of lazily computed attributes.
    '''

    cacheItems = []
    maskKeys = set()

    def __init__(self, systemConfig, *args, **kwargs):

        super().__init__(systemConfig, *args, **kwargs)
        self.systemConfig = copy.copy(systemConfig if systemConfig else {})

    @property
    def systemConfig(self):
        return self._systemConfig

    @systemConfig.setter
    def systemConfig(self, value):
        self._systemConfig = value

    def clearCache(self):
        'Delete all cached attributes named in the aggregated cacheItems.'
        for attr in _aggregate_list(self.__class__, 'cacheItems'):
            if hasattr(self, attr):
                delattr(self, attr)

    @property
    def maskedConfig(self):
        'systemConfig with the aggregated maskKeys removed.'
        mask = _aggregate_set(self.__class__, 'maskKeys')
        return {k: v for k, v in self.systemConfig.items() if k not in mask}


class SCFilter(object):
    '''
    Filters a systemConfig dict down to the keys that a target class (or
    any class in its MRO) accepts, and validates required keys.
    '''

    def __init__(self, clslist):

        if not isinstance(clslist, (list, tuple)):
            clslist = [clslist]

        self.table = {}
        for cls in clslist:
            self.table.update(_aggregate_initmap(cls))

        self.required = {key for key, (req, _, _) in self.table.items() if req}

    def __call__(self, systemConfig):

        out = {key: systemConfig[key] for key in self.table
               if key in systemConfig}
        missing = self.required - set(out)
        if missing:
            raise ValueError('Filtered config is missing required keys: %s'
                             % (sorted(missing),))
        return out
