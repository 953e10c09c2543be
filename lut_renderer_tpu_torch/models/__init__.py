from .params import ProcessingParams
from .task import Task, TaskStatus
from .video_info import VideoInfo

__all__ = ["ProcessingParams", "Task", "TaskStatus", "VideoInfo"]
