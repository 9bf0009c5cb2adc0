from .classifier import (AudioConvNet, AVSyncClassifier, SyncHead,  # noqa: F401
                         VideoR2Plus1DNet)
