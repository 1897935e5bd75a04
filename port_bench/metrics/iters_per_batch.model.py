'''Outer Krylov iterations per batch (the chunked solver's count).'''


def read(record):
    units = record['units']
    if not units or 'solves_ok' not in record:
        return None
    return sum(u['iters'] for u in units) / len(units)
