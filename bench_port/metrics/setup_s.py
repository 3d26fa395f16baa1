"""setup_s: seconds from the start of the run to the start of the window:
imports, card start, kernel builds, inputs, archives, the entry's state
(such as .zxh hints) and the warm-up pass."""


def read(obs):
    return obs.setup_s
