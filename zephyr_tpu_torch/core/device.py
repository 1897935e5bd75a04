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
