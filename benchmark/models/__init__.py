"""Model adapters: one module per configuration, named as the
configuration. Each gives `PORT_NAME` (the port's model name), `FEATURES`
(input features per object slot), `leaves(config)` (every weight's name,
shape and initialiser, as the benchmark makes it), `flops_per_frame(config)`
(the published forward's operations that the output needs, one frame) and
`lstm_widths(config)` (the hidden width of each LSTM layer, in order).
The reference of a configuration is `reference/<config>.py`."""

import torch

# an initialiser: ("uniform", k) draws U(-k, k); ("ones",) and ("zeros",)
UNIFORM, ONES, ZEROS = "uniform", "ones", "zeros"


def make_weights(leaves, seed, device):
    """The benchmark's weights: every uniform leaf cut from one
    `torch.rand` draw of a generator on `device` seeded with `seed`, in the
    order of `leaves`; float32, the type the configurations serve in."""
    total = sum(_numel(shape) for _, shape, init in leaves if init[0] == UNIFORM)
    generator = torch.Generator(device).manual_seed(seed)
    draw = torch.rand(total, generator=generator, device=device)
    weights, offset = {}, 0
    for name, shape, init in leaves:
        if init[0] == UNIFORM:
            n = _numel(shape)
            weights[name] = draw[offset:offset + n].view(shape).mul(2 * init[1]).sub_(init[1])
            offset += n
        elif init[0] == ONES:
            weights[name] = torch.ones(shape, device=device)
        else:
            weights[name] = torch.zeros(shape, device=device)
    return weights


def port_model(port_name, config, weights, device, train):
    """The port's model `port_name` at `config`'s widths on `device`,
    holding a copy of `weights` (built on the meta device, so the port's own
    initialiser never runs); in train mode when `train`."""
    from objectpermanence_tpu_torch.models.registry import get_model_spec

    spec = get_model_spec(port_name, config)
    with torch.device("meta"):
        model = spec.build(config, None)
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    return spec, model.train(train)


def _numel(shape):
    n = 1
    for d in shape:
        n *= d
    return n
