"""Parameter module walkthrough (the port of ``examples/parameter_demo.py``;
reference example/parameter.cc): declare a ``Parameter`` struct, set it
from ``key=value`` arguments, print it, its generated docs and its JSON.

    python -m dmlc_core_tpu_torch.examples.parameter_demo learning_rate=0.1 name=demo
"""

from __future__ import annotations

import sys
from typing import List, Optional

from ..params.parameter import Parameter, field


class TrainParam(Parameter):
    learning_rate = field(float, default=0.01, lower=0.0, help="Step size.")
    num_hidden = field(int, default=128, lower=1, upper=4096, help="Hidden units.")
    activation = field(
        str,
        default="relu",
        enum={"relu": "relu", "sigmoid": "sigmoid", "tanh": "tanh"},
        help="Nonlinearity.",
    )
    name = field(str, required=True, help="Run name.")
    silent = field(bool, default=False, aliases=("quiet",), help="Mute logs.")


def main(argv: Optional[List[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    kwargs = dict(kv.split("=", 1) for kv in argv)
    p = TrainParam()
    p.init(kwargs)
    print("initialized:", p.to_dict())
    print("\ngenerated docs:\n" + TrainParam.doc())
    print("json round-trip:", p.save_json())


if __name__ == "__main__":
    main()
