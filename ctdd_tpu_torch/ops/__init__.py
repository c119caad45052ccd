"""Operations of the port: process tables, indexing, and the wrappers of the
hand-written kernels."""


def kernel_wrappers() -> dict:
    """Every kernel wrapper by name; each counts its launches in `.launches`."""
    from ctdd_tpu_torch.ops import fused_update, rate_kernels

    return {"fused_tau_leap_update": fused_update.fused_tau_leap_update,
            "reverse_rates": rate_kernels.reverse_rates,
            "euler_posterior": rate_kernels.euler_posterior}


def kernel_launches() -> dict:
    """The launch count of every kernel wrapper, by name."""
    return {name: w.launches for name, w in kernel_wrappers().items()}
