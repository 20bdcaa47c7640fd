"""Generated 1024^2 frames per second of window: latent steps advanced in the
window (from the sampler's grid) / the configuration's steps per frame /
window seconds. All the work and all the time of the window."""


def read(rec):
    return rec["latent_steps"] / rec["steps_per_frame"] / rec["window_s"]
