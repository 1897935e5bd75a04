'''Seconds from the start of the process to the end of the warm-up.'''


def read(record):
    return record['setup_s']
