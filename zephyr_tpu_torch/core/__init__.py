'zephyr_tpu_torch core: declarative configuration.'
