"""The families on the program's side.  A family is one module here,
``<family>.py``, found by a configuration's ``"family"``, beside its
plain reference ``bench/reference/<family>.py``.  It gives

- ``model_config(v)``: the port's ``ModelConfig`` of a variant as the
  configuration file states it, importing ``repro_torch`` inside the
  function;
- ``train_step_flops(v, B, S)``: the model FLOPs of one training step,
  which ``mfu.train`` reads in a training cell (a MoE counts its active
  parameters, a hybrid its attention pairs in its attention layers);
- ``tiny(v, i)``: the cut of variant ``i`` to the CPU tests' size, made
  in place."""
import importlib


def load(family: str):
    """The program-side module of ``family``."""
    try:
        return importlib.import_module(f".{family}", __name__)
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{family}":
            raise
        raise ValueError(f"no family {family!r}: there is no "
                         f"bench/families/{family}.py") from None


def common(v: dict) -> dict:
    """The ``ModelConfig`` fields every family's variant states alike."""
    return dict(name=v["name"], n_layers=v["num_hidden_layers"],
                d_model=v["hidden_size"], vocab_size=v["vocab_size"],
                norm="rms", norm_eps=v["rms_norm_eps"],
                tie_embeddings=v["tie_word_embeddings"],
                quality=v["quality"], dtype="bfloat16")
