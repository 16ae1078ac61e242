"""Each package's own Params from one set of keyword arguments: the JAX
package's for the JAX side of a parity test, the port's for the port."""


def params_pair(**kw):
    """(the JAX package's Params, the port's Params) built from kw."""
    from pinocchio_tpu.config import Params as JaxParams
    from pinocchio_tpu_torch.config import Params
    return JaxParams(**kw), Params(**kw)


def bench_kwargs(n: int, **kw) -> dict:
    """The HMF_Validation switches at GridSize n, in code: BoxSize n,
    outputs z = 2, 1, 0.5, 0, no radiation, no PLC."""
    return dict(GridSize=n, BoxSize=float(n), output_z=[2.0, 1.0, 0.5, 0.0],
                norad=True, plc_enabled=False, **kw)
