"""The optimizer cases the port's optimizer tests share: each case's
class name, arguments and arguments with weight decay, and the slot
names JAX gives it."""


def _no_norm(name):
    return "norm" in name


# name -> (class name, constructor arguments, arguments when the case
# takes weight decay)
OPTS = {
    "SGD": ("SGD", {}, {"weight_decay": 0.01}),
    "Momentum": ("Momentum", {"momentum": 0.9}, {"weight_decay": 0.01}),
    "Momentum-nesterov": ("Momentum", {"momentum": 0.9,
                                       "use_nesterov": True},
                          {"weight_decay": 0.01}),
    "Adamax": ("Adamax", {}, {"weight_decay": 0.01}),
    "Adagrad": ("Adagrad", {"initial_accumulator_value": 0.1},
                {"weight_decay": 0.01}),
    "RMSProp": ("RMSProp", {}, {"weight_decay": 0.01}),
    "RMSProp-centered": ("RMSProp", {"centered": True, "momentum": 0.9},
                         {"weight_decay": 0.01}),
    "Adadelta": ("Adadelta", {}, {"weight_decay": 0.01}),
    "Lamb": ("Lamb", {"lamb_weight_decay": 0.0},
             {"lamb_weight_decay": 0.01,
              "exclude_from_weight_decay_fn": _no_norm}),
    "Rprop": ("Rprop", {}, {}),
}
SLOTS = {"SGD": set(), "Momentum": {"velocity"}, "Adamax": {"m", "u"},
         "Adagrad": {"acc"}, "RMSProp": {"ms", "mom"},
         "RMSProp-centered": {"ms", "mom", "mg"},
         "Adadelta": {"avg_sq_grad", "avg_sq_update"}, "Lamb": {"m", "v"},
         "Rprop": {"step_size", "prev_grad"}}
