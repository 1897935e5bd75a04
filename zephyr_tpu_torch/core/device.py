'''
The device of the port's entry points.

Every entry point (the discretizations' ``device`` config key,
``fwi_misfit_grad_chunked``, the ``convert`` functions) runs on the card
unless the caller asks for the CPU. Without a CUDA device the card is
refused with an error that says how to ask for the CPU: nothing falls
back to it quietly.
'''

import torch

#: the device an entry point uses when the caller names none
DEFAULT_DEVICE = 'cuda'


def resolve_device(device=DEFAULT_DEVICE):
    '''
    ``device`` as a torch.device; a CUDA device on a machine without one
    raises RuntimeError.
    '''

    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "zephyr_tpu_torch: no CUDA device here; the port runs on the "
            "card by default. Pass device='cpu' (the 'device' config key of "
            "a discretization) to run on the CPU.")
    return dev


_DTYPES = {'complex64': torch.complex64, 'complex128': torch.complex128}


def resolve_dtype(dtype, device):
    '''
    The complex dtype of a solve: ``dtype`` (a torch dtype or its name)
    when given (``device`` is then not needed), else complex64 on CUDA
    and complex128 on the CPU.
    '''

    if dtype is None:
        return (torch.complex64 if torch.device(device).type == 'cuda'
                else torch.complex128)
    if isinstance(dtype, str):
        dtype = _DTYPES[dtype]
    if dtype not in (torch.complex64, torch.complex128):
        raise ValueError('dtype must be complex64 or complex128')
    return dtype
