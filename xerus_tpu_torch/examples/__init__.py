from .poisson import qtt_poisson_instance, host_poisson_residual
