from repro_torch.training.loop import TrainResult, eval_perplexity, \
    train  # noqa: F401
from repro_torch.training.step import TrainState, init_state, \
    make_train_step, state_shardings, value_and_grad, whole_shardings  # noqa: F401,E501
