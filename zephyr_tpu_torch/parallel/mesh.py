'''
Device meshes for zephyr_tpu_torch: the port of
``zephyr_tpu.parallel.mesh``.

The reference's parallelism is a multiprocessing pool over frequency /
ky subproblems (zephyr/backend/distributors.py:70-193) plus an unused
ipyparallel stub for multi-node (distributors.py:196-240). The JAX
package lays the same decomposition on a ``jax.sharding.Mesh`` whose named
axes are 'freq' (independent operators) and 'src' (batched right-hand
sides within one operator), and GSPMD inserts the collectives.

The port keeps the names and the axes, without a compiler behind them:

- ``Mesh`` is a numpy object array of ``torch.device`` (one entry per
  mesh coordinate) with its ``axis_names``. A device may repeat: a
  **virtual mesh** (``['cpu'] * 4``, or ``['cuda:0'] * 4`` on one card)
  runs every coordinate's work in turn on that device, the port's
  counterpart of the JAX package's forced host device count. The
  sharded functions (``make_sharded_fwi_step``, the spatial
  decomposition) loop over the coordinates in one process, each block on
  its coordinate's device, as the distributors fan out over ``cuda:i % n``.
- ``freq_src_sharding`` / ``replicated`` return ``Sharding`` specs that
  split an array into the blocks of the mesh coordinates and gather them.
- Across processes, ``initialize_distributed`` starts
  ``torch.distributed`` and ``make_multihost_mesh`` builds a
  ('host', 'freq', 'src') mesh whose 'host' axis is the process group:
  each process drives its own row, and ``Mesh.psum`` adds the partial
  results over the coordinates of its row and then over 'host' by
  ``dist.all_reduce``. NCCL refuses two ranks on one GPU, so on one card
  the multi-process path runs only with the CPU and gloo.
'''

import os
from typing import Any, NamedTuple

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device


class Mesh(object):
    '''
    A named grid of devices: ``devices`` is an object array of
    ``torch.device``, ``axis_names`` names its axes. On a mesh with a
    'host' axis (``make_multihost_mesh``), this process drives the
    coordinates whose 'host' index is ``process_index``.
    '''

    def __init__(self, devices, axis_names, process_index=0):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError('Mesh: %d axis names for a %d-dimensional '
                             'device array' % (len(axis_names), arr.ndim))
        self.devices = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            self.devices[idx] = torch.device(arr[idx])
        self.axis_names = tuple(axis_names)
        self.process_index = int(process_index)

    @property
    def shape(self):
        'Axis sizes by name.'
        return dict(zip(self.axis_names, self.devices.shape))

    def coords(self):
        '''
        The coordinates this process drives, in row-major order (every
        coordinate, or on a 'host' mesh those of row ``process_index``).
        '''
        out = list(np.ndindex(self.devices.shape))
        if 'host' in self.axis_names:
            h = self.axis_names.index('host')
            out = [c for c in out if c[h] == self.process_index]
        return out

    def device(self, coord):
        return self.devices[tuple(coord)]

    def psum(self, parts):
        '''
        The sum of per-coordinate tensors ``parts`` ({coordinate: tensor},
        this process's coordinates) in row-major order on the device of
        its first coordinate (a fixed order, so the rounding does not
        depend on where the parts were computed), then over 'host' by
        ``dist.all_reduce`` when the mesh spans processes.
        '''
        coords = [c for c in self.coords() if c in parts]
        dev = self.device(coords[0])
        total = None
        for c in coords:
            p = parts[c].to(dev)
            total = p if total is None else total + p
        if 'host' in self.axis_names and self.shape['host'] > 1:
            import torch.distributed as dist
            total = total.clone()
            dist.all_reduce(total)
        return total

    def __repr__(self):
        return 'Mesh(%s, devices=%s)' % (self.shape, [
            str(d) for d in self.devices.ravel()])


class Sharding(NamedTuple):
    '''
    How an array lies on a mesh: ``spec`` names, for each leading array
    axis, the mesh axis it is split over (None: not split; a tuple of
    names: split over those axes jointly, the first slowest), as a
    ``PartitionSpec``; axes past the spec are not split. Splits must be
    even, as in the JAX package.
    '''
    mesh: Any
    spec: tuple

    def _parts(self, entry):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        return [self.mesh.axis_names.index(n) for n in names]

    def block(self, shape, coord):
        'The slices of the block at mesh coordinate ``coord``.'
        sl = []
        sizes = self.mesh.devices.shape
        for dim, entry in enumerate(self.spec):
            n, i = 1, 0
            for a in self._parts(entry):
                n, i = n * sizes[a], i * sizes[a] + coord[a]
            if shape[dim] % n:
                raise ValueError('Sharding %s: axis %d of size %d does not '
                                 'split evenly %d ways'
                                 % (self.spec, dim, shape[dim], n))
            w = shape[dim] // n
            sl.append(slice(i * w, (i + 1) * w))
        return tuple(sl)

    def shard(self, a, coord, dtype=None):
        '''
        The block of ``a`` (a numpy array or a tensor) at ``coord`` as a
        contiguous tensor on that coordinate's device (in ``dtype`` if
        given).
        '''
        blk = a[self.block(a.shape, coord)]
        if not isinstance(blk, torch.Tensor):
            blk = torch.as_tensor(np.ascontiguousarray(blk))
        # a shard owns contiguous storage, as a device buffer would (the
        # kernels take contiguous operands)
        return blk.to(device=self.mesh.device(coord),
                      dtype=dtype).contiguous()

    def split(self, a, dtype=None):
        "{coordinate: block} over this process's coordinates."
        return {c: self.shard(a, c, dtype) for c in self.mesh.coords()}

    def gather(self, parts, device=None):
        '''
        The global tensor from {coordinate: block} covering every block,
        on ``device`` (default the first coordinate's).
        '''
        coords = list(parts)
        first = parts[coords[0]]
        sizes = self.mesh.devices.shape
        shape = list(first.shape)
        for dim, entry in enumerate(self.spec):
            for a in self._parts(entry):
                shape[dim] *= sizes[a]
        dev = device or self.mesh.device(coords[0])
        out = torch.empty(shape, dtype=first.dtype, device=dev)
        for c in coords:
            out[self.block(shape, c)] = parts[c].to(dev)
        return out


def _devices(devices):
    'The given devices, or every CUDA device (raising without one).'
    if devices is not None:
        return [torch.device(d) for d in devices]
    resolve_device(DEFAULT_DEVICE)
    return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]


def _axis_sizes(freq, src, n):
    if freq is None and src is None:
        freq, src = n, 1
    elif freq is None:
        freq = n // src
    elif src is None:
        src = n // freq
    if freq * src > n:
        raise ValueError('mesh of %d x %d larger than the %d devices'
                         % (freq, src, n))
    return freq, src


def make_mesh(freq=None, src=None, devices=None):
    '''
    Build a ('freq', 'src') mesh over the devices.

    Args:
        freq, src: axis sizes; by default all devices go to 'freq'.
        devices: optional explicit device list (default: every CUDA
            device; without one it raises). A list that repeats a device
            (``['cpu'] * 4``) makes a virtual mesh.

    Returns:
        Mesh
    '''

    devices = _devices(devices)
    freq, src = _axis_sizes(freq, src, len(devices))
    dev_array = np.empty(freq * src, dtype=object)
    dev_array[:] = devices[:freq * src]
    return Mesh(dev_array.reshape((freq, src)), axis_names=('freq', 'src'))


def freq_src_sharding(mesh):
    '''
    The Sharding that splits axis 0 over 'freq' and axis 1 over 'src'; on
    a mesh with a 'host' axis axis 0 splits over ('host', 'freq'), so each
    process takes its own block of frequencies (the JAX package's spec
    replicates over 'host' and leaves the split to GSPMD).
    '''
    f = ('host', 'freq') if 'host' in mesh.axis_names else 'freq'
    return Sharding(mesh, (f, 'src'))


def replicated(mesh):
    'The Sharding that gives every coordinate the whole array.'
    return Sharding(mesh, ())


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, local_device_ids=None):
    '''
    Multi-process bring-up: start ``torch.distributed`` so that every
    process joins one group and ('host', ...) meshes span the processes.
    Call it ONCE per process, on every process:

        initialize_distributed('host0:29500', 2, rank)

    The arguments default to torch's environment conventions where the
    JAX package reads ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES``
    / ``JAX_PROCESS_ID``: ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``
    and ``RANK``. The backend is NCCL when CUDA devices are local (their
    ids ``local_device_ids``, default all; NCCL takes one rank a GPU) and
    gloo on the CPU. A single-process call (one process) is a no-op, so
    the same driver script runs unmodified in one process; more than one
    process without an address raises ValueError.

    Returns True if the process group was (already) initialized, False
    for the single-process no-op.
    '''

    import torch.distributed as dist

    if coordinator_address is None and os.environ.get('MASTER_ADDR'):
        coordinator_address = '%s:%s' % (os.environ['MASTER_ADDR'],
                                         os.environ.get('MASTER_PORT',
                                                        '29500'))
    if num_processes is None:
        env = os.environ.get('WORLD_SIZE')
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get('RANK')
        process_id = int(env) if env else None

    if dist.is_initialized():
        return True     # already initialized

    if coordinator_address is None:
        if num_processes in (None, 1):
            return False   # single-process: nothing to initialize
        raise ValueError(
            'initialize_distributed: num_processes=%r needs a '
            'coordinator_address (or MASTER_ADDR and MASTER_PORT)'
            % (num_processes,))

    cuda = torch.cuda.is_available() and (local_device_ids is None
                                          or len(local_device_ids) > 0)
    if cuda:
        ids = list(local_device_ids or range(torch.cuda.device_count()))
        torch.cuda.set_device(ids[0])
    dist.init_process_group(
        backend='nccl' if cuda else 'gloo',
        init_method='tcp://%s' % coordinator_address,
        world_size=int(num_processes), rank=int(process_id or 0))
    return True


def make_multihost_mesh(freq=None, src=None, devices=None):
    '''
    A ('host', 'freq', 'src') mesh over every process: the leading axis
    enumerates the processes of the ``torch.distributed`` group, the
    trailing axes subdivide each process's local devices (``devices``,
    default every CUDA device, raising without one; a repeated device
    makes a virtual mesh, as in ``make_mesh``). Lay frequency
    blocks across hosts: frequencies are independent subproblems, so the
    only traffic between processes is the final gradient / misfit
    all-reduce, the communication pattern the reference's per-process
    frequency pool implies (zephyr/backend/distributors.py:127-173).

    Requires ``initialize_distributed()`` first on more than one process;
    in one process this is a ('host'=1, 'freq', 'src') mesh, so code
    written against it runs unmodified. Row h of ``devices`` names the
    devices process h drives (each process the same local names).
    '''

    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        nproc, rank = dist.get_world_size(), dist.get_rank()
    else:
        nproc, rank = 1, 0
    local = _devices(devices)
    freq, src = _axis_sizes(freq, src, len(local))
    devs = np.empty((nproc, freq * src), dtype=object)
    for h in range(nproc):
        devs[h, :] = local[:freq * src]
    return Mesh(devs.reshape((nproc, freq, src)),
                axis_names=('host', 'freq', 'src'), process_index=rank)
