"""RL substrate for the paper's experiments: CartPole-v0 and GridWorld,
A2C and double-dueling-DQN agents exposing the DDAL callback protocol
(port of ``repro.rl``)."""
from repro_torch.rl.a2c import (  # noqa: F401
    A2CState,
    a2c_loss,
    init_a2c,
    make_a2c_callbacks,
    make_a2c_group,
)
from repro_torch.rl.dqn import (  # noqa: F401
    DQNConfig,
    DQNState,
    dqn_loss,
    init_dqn,
    make_dqn_callbacks,
    make_dqn_group,
)
from repro_torch.rl.envs import CartPole, GridWorld  # noqa: F401
from repro_torch.rl.rollout import (  # noqa: F401
    Trajectory,
    episode_return,
    obs_moments,
    run_episode,
)
