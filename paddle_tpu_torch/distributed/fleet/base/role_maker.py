"""Role makers (a copy of ``paddle_tpu/distributed/fleet/base/role_maker.py``;
reference: fluid/incubate/fleet/base/role_maker.py:480
PaddleCloudRoleMaker, UserDefinedRoleMaker).

The role maker answers "who am I in this job": worker/server index, world
size, endpoints — derived from the PaddleCloud scheduler's env contract
(PADDLE_TRAINERS_NUM / PADDLE_TRAINER_ID / TRAINING_ROLE / POD_IP /
PADDLE_PORT / PADDLE_TRAINER_ENDPOINTS).  In this framework there is no
parameter-server runtime (SURVEY §7 declares the PS stack a non-goal), so
PSERVER roles are recognized and reported but ``is_server`` jobs cannot
enter the collective path; everything else is a drop-in surface for code
written against fleet.init(role_maker=...).
"""

from __future__ import annotations

import os
from typing import List, Optional


class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    def __init__(self):
        self._worker_endpoints: List[str] = []
        self._server_endpoints: List[str] = []
        self._role: Optional[int] = None
        self._current_id = -1
        self._role_is_generated = False

    def _generate_role(self):
        raise NotImplementedError

    def _ensure(self):
        if not self._role_is_generated:
            self._generate_role()

    # -- queries (reference RoleMakerBase surface) --------------------------
    def _is_worker(self) -> bool:
        self._ensure()
        return self._role == Role.WORKER

    is_worker = _is_worker

    def _is_server(self) -> bool:
        self._ensure()
        return self._role == Role.SERVER

    is_server = _is_server

    def _is_first_worker(self) -> bool:
        return self._is_worker() and self._worker_index() == 0

    is_first_worker = _is_first_worker

    def _worker_num(self) -> int:
        self._ensure()
        return max(len(self._worker_endpoints), 1)

    worker_num = _worker_num

    def _server_num(self) -> int:
        self._ensure()
        return len(self._server_endpoints)

    server_num = _server_num

    def _worker_index(self) -> int:
        self._ensure()
        return self._current_id

    worker_index = _worker_index

    def _server_index(self) -> int:
        self._ensure()
        return self._current_id

    server_index = _server_index

    def _get_trainer_endpoints(self) -> List[str]:
        self._ensure()
        return list(self._worker_endpoints)

    get_trainer_endpoints = _get_trainer_endpoints

    def _get_pserver_endpoints(self) -> List[str]:
        self._ensure()
        return list(self._server_endpoints)

    get_pserver_endpoints = _get_pserver_endpoints

    def role_id(self) -> int:
        return self._worker_index() if self._is_worker() else self._server_index()


class PaddleCloudRoleMaker(RoleMakerBase):
    """Reads the PaddleCloud env contract (reference role_maker.py:480).

    Collective mode (the training path): every process is a TRAINER; identity
    comes from PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM /
    PADDLE_TRAINER_ENDPOINTS.  PS mode parses TRAINING_ROLE and the
    server lists for surface parity.
    """

    def __init__(self, is_collective: bool = False, **kwargs):
        super().__init__()
        self._is_collective = is_collective
        self._kwargs = kwargs

    def _generate_role(self):
        if self._is_collective:
            self._worker_endpoints = [
                e for e in os.getenv("PADDLE_TRAINER_ENDPOINTS", "").split(",")
                if e]
            self._current_id = int(os.getenv("PADDLE_TRAINER_ID", "0"))
            if not self._worker_endpoints:
                n = int(os.getenv("PADDLE_TRAINERS_NUM", "1"))
                self._worker_endpoints = [f"127.0.0.1:{6170 + i}"
                                          for i in range(n)]
            self._role = Role.WORKER
        else:
            role = os.getenv("TRAINING_ROLE", "TRAINER").upper()
            if role not in ("TRAINER", "PSERVER"):
                raise ValueError(
                    f"TRAINING_ROLE must be PSERVER or TRAINER, got {role!r}")
            self._server_endpoints = [
                e for e in os.getenv("PADDLE_PSERVERS_IP_PORT_LIST",
                                     "").split(",") if e]
            self._worker_endpoints = [
                e for e in os.getenv("PADDLE_TRAINER_ENDPOINTS", "").split(",")
                if e]
            if role == "TRAINER":
                self._role = Role.WORKER
                self._current_id = int(os.getenv("PADDLE_TRAINER_ID", "0"))
                if not self._worker_endpoints:
                    # PS-mode trainers usually don't see each other's
                    # endpoints; world size still comes from the scheduler
                    n = int(os.getenv("PADDLE_TRAINERS_NUM", "1"))
                    self._worker_endpoints = [f"trainer:{i}" for i in range(n)]
            else:
                self._role = Role.SERVER
                ip = os.getenv("POD_IP", "127.0.0.1")
                port = os.getenv("PADDLE_PORT", "")
                me = f"{ip}:{port}"
                if me not in self._server_endpoints:
                    # duplicate/ambiguous identity is worse than failing fast
                    # (the reference raises on an unmatched current endpoint)
                    raise ValueError(
                        f"current server endpoint {me!r} not in "
                        f"PADDLE_PSERVERS_IP_PORT_LIST {self._server_endpoints}")
                self._current_id = self._server_endpoints.index(me)
        self._role_is_generated = True


class UserDefinedRoleMaker(RoleMakerBase):
    """Roles passed explicitly (reference UserDefinedRoleMaker)."""

    def __init__(self, current_id: int = 0, role: int = Role.WORKER,
                 worker_num: int = 1, server_endpoints: Optional[List[str]] = None,
                 worker_endpoints: Optional[List[str]] = None):
        super().__init__()
        self._current_id = current_id
        self._role = role
        self._server_endpoints = list(server_endpoints or [])
        self._worker_endpoints = list(
            worker_endpoints or [f"127.0.0.1:{6170 + i}"
                                 for i in range(worker_num)])

    def _generate_role(self):
        self._role_is_generated = True
