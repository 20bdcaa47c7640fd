"""Host-side data: loaders, cameras, crops and the synthetic scene (numpy /
PIL, the port's own copies of the JAX package's modules of the same names)
and the ray math ported to torch (:mod:`.rays`)."""

from diffuman4d_torch.data.dataset import Sample, SpaTemDataset
from diffuman4d_torch.data.synthetic import make_synthetic_scene

__all__ = ["Sample", "SpaTemDataset", "make_synthetic_scene"]
