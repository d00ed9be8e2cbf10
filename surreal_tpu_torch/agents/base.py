"""The agent layer, the port of ``surreal_tpu/agents/base.py``
(``AGENT_MODES``, ``Agent``).

An agent binds a learner to a mode ('training', 'eval_deterministic',
'eval_stochastic') and acts in two ways, as in the reference:

- **in the program**: :meth:`Agent.act` acts through the learner's
  ``act`` on a state the caller holds;
- **remote** (a process outside the training session: the ``actor`` and
  ``eval --follow`` subcommands): :meth:`Agent.connect` gives the agent a
  :class:`~surreal_tpu_torch.distributed.param_service.ParameterClient`
  and a local full learner state; :meth:`Agent.remote_act` fetches the
  published acting view every ``fetch_every`` acts, merges it into that
  state (on the learner's device, the card by default) and acts from it;
  :attr:`Agent.param_version` is the version acted with.

Randomness is explicit, as everywhere in the port: each act takes a
``torch.Generator`` or the draw itself (``noise``: the Gaussian action
noise or the categorical Gumbel draws, as ``Learner.act`` takes them).

An agent applies its learner's modules; a thread other than the main one
acts through an agent built on ``learner.acting_copy()`` (made on the main
thread), since ``functional_call`` swaps parameters into the modules.
Subclasses narrow :meth:`Agent.acting_view` to what their actor needs on
the wire.
"""

from __future__ import annotations

import torch

from surreal_tpu_torch.learners.base import EVAL_DETERMINISTIC, EVAL_STOCHASTIC, TRAINING, Learner

AGENT_MODES = (TRAINING, EVAL_DETERMINISTIC, EVAL_STOCHASTIC)


class Agent:
    """A mode-bound acting view of a learner."""

    def __init__(self, learner: Learner, mode: str = TRAINING):
        if mode not in AGENT_MODES:
            raise ValueError(f"mode {mode!r} not in {AGENT_MODES}")
        self.learner = learner
        self.mode = mode
        self._client = None
        self.state = None  # the local full state; remote path only
        self._act_carry = None  # a trajectory policy's context; remote path only
        self._act_carry_batch = None

    @property
    def device(self) -> torch.device:
        return self.learner.device

    def _obs(self, obs) -> torch.Tensor:
        """``obs`` (a tensor or a numpy array) on the learner's device."""
        return torch.as_tensor(obs).to(self.device, non_blocking=True)

    def act(self, state, obs, generator: torch.Generator | None = None, noise: torch.Tensor | None = None):
        """Batched action and behaviour ``action_info`` from ``state``."""
        return self.learner.act(state, self._obs(obs), self.mode, generator, noise=noise)

    def eval_view(self, deterministic: bool = True) -> "Agent":
        return type(self)(self.learner, EVAL_DETERMINISTIC if deterministic else EVAL_STOCHASTIC)

    # -- remote actor --------------------------------------------------------
    def acting_view(self, state) -> dict:
        """What an actor needs of the state: the wire payload published and
        fetched. PPO's and IMPALA's states share (params, obs_stats); the
        obs normalizer rides along, as the reference broadcast it."""
        return {"params": state.params, "obs_stats": state.obs_stats}

    def connect(self, server_address: str, state, fetch_every: int = 1) -> "Agent":
        """Attach to a parameter server. ``state``: this process's full
        learner state (``learner.init``), into which fetched views are
        merged; ``fetch_every``: the fetch cadence in acts. A trajectory
        policy's context starts afresh."""
        from surreal_tpu_torch.distributed.param_service import ParameterClient

        if fetch_every < 1:
            raise ValueError(f"fetch_every must be >= 1, got {fetch_every}")
        self._act_carry = None
        self._act_carry_batch = None
        self.state = state
        self._client = ParameterClient(server_address, self.acting_view(state))
        self._fetch_every = fetch_every
        self._acts_since_fetch = fetch_every  # fetch before the first act
        return self

    @property
    def param_version(self) -> int:
        """The version of the last fetched view (0 before the first)."""
        return 0 if self._client is None else self._client.version

    def peek_published_version(self, timeout_ms: int = 5000) -> int:
        """The server's newest published version, without the blob (0 when
        nothing is published); ``TimeoutError`` on a silent server."""
        if self._client is None:
            raise RuntimeError("peek_published_version before connect()")
        return self._client.peek_version(timeout_ms)

    def fetch_params(self) -> bool:
        """Fetch now; True when a new view was merged. A server timeout
        keeps the local copy and returns False (the client has replaced
        its socket for the next try)."""
        if self._client is None:
            raise RuntimeError("fetch_params before connect()")
        self._acts_since_fetch = 0
        try:
            view = self._client.fetch()
        except TimeoutError:
            return False
        if view is None:
            return False
        self.state = self.state._replace(**view)
        return True

    def remote_act(self, obs, generator: torch.Generator | None = None, noise: torch.Tensor | None = None):
        """Act from the local state, fetching every ``fetch_every`` acts
        (acting goes on from the copy held when nothing new is published or
        the server is slow). A trajectory policy acts through
        ``act_init``/``act_step`` with its context kept here: made afresh
        when the batch size changes, kept across fetches (as the
        reference's recurrent agents kept their state)."""
        if self._client is None:
            raise RuntimeError("remote_act before connect()")
        self._acts_since_fetch += 1
        if self._acts_since_fetch >= self._fetch_every:
            self.fetch_params()
        if not self.learner.requires_act_carry:
            return self.act(self.state, obs, generator, noise)
        obs = self._obs(obs)
        B = int(obs.shape[0])
        if self._act_carry is None or self._act_carry_batch != B:
            self._act_carry = self.learner.act_init(B)
            self._act_carry_batch = B
        action, info, self._act_carry = self.learner.act_step(
            self.state, self._act_carry, obs, self.mode, generator, noise=noise
        )
        return action, info

    def close(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None
