"""RL substrate for the paper's experiments: CartPole-v0 and A2C agents
exposing the DDAL callback protocol (port of ``repro.rl``)."""
