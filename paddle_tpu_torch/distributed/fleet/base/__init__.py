from .distributed_strategy import DistributedStrategy  # noqa: F401
from .role_maker import (PaddleCloudRoleMaker, Role, RoleMakerBase,  # noqa: F401
                         UserDefinedRoleMaker)
